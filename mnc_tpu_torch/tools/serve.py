"""Serve MNC — the port's counterpart of ``tools/serve.py``: image paths in
(arguments or stdin, one per line), one JSON line of detections per image
out, with boxes, classes, scores and RLE-compressed masks (decode with
``mnc_tpu_torch.native.rle_decode``); or, with ``--http``, an HTTP server
(``pipeline/server.py``).

    python3 -m mnc_tpu_torch.tools.serve [--ckpt DIR | --npz PATH |
        --caffemodel PATH [--remap OLD=NEW ...] | --exported PATH] \\
        [--cfg FILE] [--set KEY VAL ...] [--conf 0.7] [--device cpu] \\
        [--http PORT [--http-batch B] [--http-wait-ms MS]] [--prewarm] [img ...]

Each file is read as bytes and decoded as an HTTP body is
(``server.decode_image``): a ``.npy`` of an (H, W, 3) uint8 BGR array
anywhere, jpg/png where cv2 imports (the machine with the card has none).
``--exported`` serves a single-image ``torch.export`` artifact
(``tools/export_model.py --program``) without building the model.  It runs
on the GPU unless ``--device cpu`` is given, and raises without one.  An
artifact runs on the device it was exported on, so ``--device`` must name
that device: a CPU artifact needs ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Serve MNC (PyTorch port)")
    ap.add_argument("images", nargs="*")
    ap.add_argument("--ckpt", default=None,
                    help="train_net checkpoint: a ckpt_<step> dir or the run dir (newest)")
    ap.add_argument("--remap", nargs="*", default=None, metavar="OLD=NEW",
                    help="rename caffemodel layers before matching")
    ap.add_argument("--caffemodel", default=None, help="reference .caffemodel weights")
    ap.add_argument("--npz", default=None,
                    help="save_npz export or train_net state (params/... names)")
    ap.add_argument("--exported", default=None, metavar="PATH",
                    help="serve a single-image torch.export artifact (export_model.py "
                         "--program): weights and program in one file, no model build; "
                         "excludes --http-batch (one fixed canvas per artifact)")
    ap.add_argument("--stages", type=int, default=5, choices=(3, 5))
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--conf", type=float, default=0.7)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead of the path loop: POST /detect "
                         "(jpg/png or HWC uint8 .npy body), GET /healthz")
    ap.add_argument("--http-batch", type=int, default=0, metavar="B",
                    help="micro-batch concurrent /detect requests up to B per device "
                         "call (detect_many; 0 = one at a time)")
    ap.add_argument("--http-wait-ms", type=float, default=10.0,
                    help="max coalescing wait for --http-batch")
    ap.add_argument("--prewarm", action="store_true",
                    help="run every canvas variant (and the batched program under "
                         "--http-batch) once BEFORE accepting work, so the kernels are "
                         "built and the allocator holds its pools")
    return ap.parse_args(argv)


def dets_to_json(dets: dict, conf: float) -> dict:
    """A ``detect`` dict → the reply: the valid instances scoring at least
    ``conf``, boxes to 0.1 px, scores to 1e-4, masks as RLE."""
    from mnc_tpu_torch import native

    instances = []
    for k in range(len(dets["scores"])):
        if not dets["valid"][k] or dets["scores"][k] < conf:
            continue
        rle = native.rle_encode(dets["full_masks"][k])
        instances.append({
            "box": [round(float(v), 1) for v in dets["boxes"][k]],
            "class_id": int(dets["classes"][k]),
            "score": round(float(dets["scores"][k]), 4),
            "mask_rle": {"size": list(rle["size"]), "counts": rle["counts"].tolist()},
        })
    return {"instances": instances}


def load_pipeline(args):
    """The pipeline ``args`` ask for: an ``ExportedPipeline`` or an
    ``MNCPipeline`` with the imported weights, prewarmed with ``--prewarm``."""
    import numpy as np

    from mnc_tpu_torch.config import cfg_from_file, cfg_from_list
    from mnc_tpu_torch.utils.device import resolve_device

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    if args.exported:
        if args.http_batch:
            raise SystemExit("--exported serves the single-image artifact; --http-batch "
                             "needs the full pipeline")
        from mnc_tpu_torch.pipeline.export import ExportedPipeline

        pipe = ExportedPipeline(args.exported, device=device)
        print(f"loaded exported program ({pipe.canvas} canvas, {pipe.device}) from "
              f"{args.exported}", flush=True)
        if args.prewarm:
            t0 = time.perf_counter()
            pipe.detect(np.zeros((*pipe.canvas, 3), np.uint8))
            print(f"prewarmed exported program in {time.perf_counter() - t0:.1f}s", flush=True)
        return pipe

    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.pipeline.inference import PostCfg
    from mnc_tpu_torch.tools.test_net import build_pipeline
    from mnc_tpu_torch.utils.checkpoint import checkpoint_npz

    npz = checkpoint_npz(args.ckpt) if args.ckpt and not args.npz else args.npz
    pipe, _ = build_pipeline(MNCArch.from_cfg(train=False, n_stages=args.stages), device,
                             args.caffemodel, npz, args.remap,
                             PostCfg.from_cfg(score_thresh=0.0))
    if args.prewarm:
        t0 = time.perf_counter()
        warmed = pipe.prewarm(batch_size=args.http_batch or None)
        print(f"prewarmed {len(warmed)} canvas variants {warmed} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return pipe


def build_server(args, pipe, host: str = "0.0.0.0"):
    """The ``--http`` server over ``pipe`` (not started): micro-batched
    through ``detect_many`` with ``--http-batch``, else one request at a
    time through ``detect``."""
    from mnc_tpu_torch.pipeline.server import make_http_server

    if args.http_batch:
        b = args.http_batch

        def batch_to_json(imgs):
            return [dets_to_json(d, args.conf) for d in pipe.detect_many(imgs, batch_size=b)]

        return make_http_server(batch_fn=batch_to_json, host=host, port=args.http,
                                max_batch=b, max_wait_ms=args.http_wait_ms)
    return make_http_server(lambda im: dets_to_json(pipe.detect(im), args.conf), host=host,
                            port=args.http)


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.pipeline.server import decode_image

    pipe = load_pipeline(args)
    if args.http is not None:
        srv = build_server(args, pipe)
        print(f"serving on :{srv.server_address[1]} (POST /detect, GET /healthz)", flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
            if srv.batcher is not None:
                srv.batcher.close()
        return 0

    for line in args.images or sys.stdin:
        path = line.strip()
        try:
            with open(path, "rb") as f:
                im = decode_image(f.read())
        except OSError:
            im = None
        if im is None:
            print(json.dumps({"image": path, "error": "unreadable"}), flush=True)
            continue
        print(json.dumps({"image": path, **dets_to_json(pipe.detect(im), args.conf)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
