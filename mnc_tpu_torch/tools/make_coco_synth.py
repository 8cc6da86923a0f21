"""Emit a synthetic shapes dataset in COCO format — the port's counterpart of
``tools/make_coco_synth.py`` (the same images, annotations and json).

Writes real jpgs under ``<root>/images/<split>/`` and an
``<root>/annotations/instances_<split>.json`` whose segmentations alternate
between polygon lists and compressed RLE strings, so that the COCO chain
(``data.coco.COCOSeg`` → ``TrainLoader`` → ``train_net`` → ``test_net
--coco-ap``) runs on data made here:

    python3 -m mnc_tpu_torch.tools.make_coco_synth --root data/coco_synth \\
        --splits synthtrain=64 synthval=16
    python3 -m mnc_tpu_torch.tools.train_net --imdb coco_synthtrain \\
        --set DATA_DIR data/coco_synth ...

It writes jpgs and finds polygons with cv2 (imported when it runs), as the
JAX tool does; a tree for a machine without cv2 needs PNG images and RLE
segmentations only (``data.coco.encode_coco_rle``, ``utils.png.imwrite``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np


def emit_coco_synth(root: str, split: str, num_images: int, canvas_hw=(480, 640),
                    num_classes=6, seed=0, n_range=(2, 5), quality=95) -> str:
    """Write the images and the annotations of one split under ``root``;
    returns the annotations' path."""
    import cv2

    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.data.coco import encode_coco_rle
    from mnc_tpu_torch.data.synthetic import SHAPE_NAMES, SyntheticShapes

    gen = SyntheticShapes(canvas_hw=canvas_hw, num_classes=num_classes, max_gt=8,
                          gt_mask_size=112, n_range=n_range, seed=seed, num_images=num_images)
    img_dir = osp.join(root, "images", split)
    ann_dir = osp.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    means = np.asarray(cfg.PIXEL_MEANS).reshape(1, 1, 3)
    h, w = canvas_hw
    for i in range(num_images):
        ex = gen.example(i)
        # synthetic scenes are mean-subtracted floats; shifted back into the
        # BGR uint8 gamut for a real jpg (the loader subtracts the means again)
        bgr = np.clip(ex["image"] + means, 0, 255).astype(np.uint8)
        fname = f"{split}_{i:06d}.jpg"
        cv2.imwrite(osp.join(img_dir, fname), bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
        image_id = i + 1
        images.append({"id": image_id, "file_name": fname, "height": h, "width": w})
        fulls = gen.full_masks(i)
        k = 0
        for g in range(gen.max_gt):
            if not ex["gt_valid"][g]:
                continue
            mask = (fulls[k] > 0.5).astype(np.uint8)
            k += 1
            x1, y1, x2, y2 = ex["gt_boxes"][g]
            area = float(mask.sum())
            if area < 1:
                continue
            if ann_id % 2:  # odd ids: polygons
                contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                               cv2.CHAIN_APPROX_SIMPLE)
                seg = [c.reshape(-1).astype(float).tolist() for c in contours if len(c) >= 3]
                if not seg:
                    continue
            else:  # even ids: compressed RLE
                seg = encode_coco_rle(mask)
            annotations.append({
                "id": ann_id, "image_id": image_id, "category_id": int(ex["gt_classes"][g]),
                "bbox": [float(x1), float(y1), float(x2 - x1 + 1), float(y2 - y1 + 1)],
                "area": area, "iscrowd": 0, "segmentation": seg})
            ann_id += 1
    categories = [{"id": c, "name": SHAPE_NAMES[c - 1], "supercategory": "shape"}
                  for c in range(1, num_classes)]
    ann_path = osp.join(ann_dir, f"instances_{split}.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    n_poly = sum(isinstance(a["segmentation"], list) for a in annotations)
    print(f"{split}: {len(images)} images, {len(annotations)} annotations ({n_poly} polygon / "
          f"{len(annotations) - n_poly} RLE) → {ann_path}")
    return ann_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Emit synthetic shapes in COCO format")
    ap.add_argument("--root", default="data/coco_synth",
                    help="DATA_DIR to emit under (the dataset goes to ROOT/coco)")
    ap.add_argument("--splits", nargs="+", default=["synthtrain=64", "synthval=16"],
                    metavar="NAME=N")
    ap.add_argument("--canvas", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--num-classes", type=int, default=6)
    ap.add_argument("--n-range", type=int, nargs=2, default=[2, 5])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for spec in args.splits:
        name, n = spec.split("=")
        emit_coco_synth(osp.join(args.root, "coco"), name, int(n),
                        canvas_hw=tuple(args.canvas), num_classes=args.num_classes,
                        seed=args.seed, n_range=tuple(args.n_range))
    print(f"done — use with --set DATA_DIR {args.root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
