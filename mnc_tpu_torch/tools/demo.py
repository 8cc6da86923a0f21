"""MNC demo — the port's counterpart of ``tools/demo.py`` (≙ the reference
``tools/demo.py``).

Runs instance segmentation over the images of ``--im-dir`` and writes
color overlays to ``--out``; with ``--synthetic`` it draws and detects
synthetic shapes instead of reading files.  Without weights it runs the
seeded random init (a pipeline smoke).

    python3 -m mnc_tpu_torch.tools.demo [--npz PATH | --caffemodel PATH] \\
        [--im-dir data/demo] [--out data/demo/out] [--conf 0.7] \\
        [--synthetic] [--stages 5] [--cfg FILE] [--set KEY VAL ...] [--device cpu]

Images are read with ``cv2`` or PIL, whichever imports; where neither does
(as on the machine with the GPU) PNG files are read by ``utils.png.imread``
(cv2's result, bit for bit) and any other format is an error that names
the file.  Overlays are written with cv2 or PIL, or as PNG by the standard
library.  ``--synthetic`` reads no file.  It runs on the GPU
unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MNC demo (PyTorch port)")
    ap.add_argument("--npz", default=None, help="save_npz export or train_net state")
    ap.add_argument("--caffemodel", default=None, help="reference .caffemodel weights")
    ap.add_argument("--remap", nargs="*", default=None, metavar="OLD=NEW",
                    help="rename caffemodel layers before matching")
    ap.add_argument("--im-dir", default="data/demo")
    ap.add_argument("--out", default="data/demo/out")
    ap.add_argument("--conf", type=float, default=None)
    ap.add_argument("--stages", type=int, default=5, choices=(3, 5))
    ap.add_argument("--cfg", default=None, help="YAML config override")
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _imread(path: str) -> np.ndarray:
    """BGR uint8 (H, W, 3) with cv2, else PIL, else ``utils.png.imread``
    (PNG content only; anything else raises an error that names the file)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        im = cv2.imread(path)
        if im is None:
            raise ValueError(f"cannot read image {path}")
        return im
    try:
        from PIL import Image
    except ImportError:
        from mnc_tpu_torch.utils import png

        return png.imread(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))[..., ::-1].copy()


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8, by the standard library."""
    from mnc_tpu_torch.utils.png import encode_png

    return encode_png(rgb)


def _imwrite(path: str, bgr: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, bgr)
        return
    except ImportError:
        pass
    try:
        from PIL import Image

        Image.fromarray(bgr[..., ::-1]).save(path)
    except ImportError:
        with open(osp.splitext(path)[0] + ".png", "wb") as f:
            f.write(_png_bytes(np.ascontiguousarray(bgr[..., ::-1])))


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.pipeline.inference import PostCfg
    from mnc_tpu_torch.tools.test_net import build_pipeline
    from mnc_tpu_torch.utils.device import resolve_device
    from mnc_tpu_torch.utils.timer import Timer
    from mnc_tpu_torch.utils.vis import vis_seg

    device = resolve_device(args.device)
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    arch = MNCArch.from_cfg(train=False, n_stages=args.stages)
    pipe, arch = build_pipeline(arch, device, args.caffemodel, args.npz, args.remap,
                                PostCfg.from_cfg(score_thresh=0.0))
    conf = args.conf if args.conf is not None else cfg.TEST.CONF_THRESH
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic:
        from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

        imdb = SyntheticIMDB(canvas_hw=arch.canvas, num_images=4)
        for i in imdb.image_index:
            ex = imdb.example(i)
            dets = {k: v.cpu().numpy() for k, v in
                    pipe.detect_canvas(ex["image"], ex["im_info"]).items()}
            dets["full_masks"] = dets.pop("canvas_masks").astype(np.uint8)
            img_vis = np.clip(ex["image"] + 127, 0, 255).astype(np.uint8)
            path = osp.join(args.out, f"synthetic_{i}.png")
            _imwrite(path, vis_seg(img_vis, dets, imdb.classes, score_thresh=conf))
            kept = int((dets["valid"] & (dets["scores"] >= conf)).sum())
            print(f"synthetic_{i}: {kept} detections ≥ {conf} → {path}")
        return 0

    images = sorted(sum((glob.glob(osp.join(args.im_dir, p))
                         for p in ("*.jpg", "*.png", "*.jpeg")), []))
    if not images:
        print(f"no images found in {args.im_dir}")
        return 0
    timer = Timer()
    for path in images:
        im = _imread(path)
        timer.tic()
        dets = pipe.detect(im)
        t = timer.toc(average=False)
        out_path = osp.join(args.out, osp.basename(path))
        _imwrite(out_path, vis_seg(im, dets, VOC_CLASSES, score_thresh=conf))
        kept = int((dets["valid"] & (dets["scores"] >= conf)).sum())
        print(f"{osp.basename(path)}: detect {t:.3f}s, {kept} instances → {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
