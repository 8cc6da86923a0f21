"""Convert MCG segment proposals to the segdb format of the CFM path — the
port's counterpart of ``tools/prepare_mcg_maskdb.py`` (≙ the reference
``tools/prepare_mcg_maskdb.py``).

Reads one MCG ``.mat`` file per image (a superpixel label map and, per
candidate, its superpixel labels), rebuilds the top-k candidates' binary
masks, crops each to its bounding box and resizes it to a fixed size
(``utils.blob.resize_mask_area``, cv2's INTER_AREA arithmetic), and writes
one pickled record per image, ``{"index", "boxes" (n, 4) f32 in image
coordinates, "masks" (n, S, S) f32}``, that ``data.loader.TrainLoader`` and
``tools.test_net --segdb`` read.  An image without a ``.mat`` is skipped.
numpy and ``scipy.io.loadmat`` only.

    python3 -m mnc_tpu_torch.tools.prepare_mcg_maskdb --mcg-dir data/MCG-raw \\
        --image-list data/sbd/val.txt --out data/cache/mcg_maskdb \\
        [--mask-size 21] [--top-k 300]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from mnc_tpu_torch.utils.blob import resize_mask_area


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MCG proposals → CFM segdb records")
    ap.add_argument("--mcg-dir", required=True)
    ap.add_argument("--image-list", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mask-size", type=int, default=21)
    ap.add_argument("--top-k", type=int, default=300)
    return ap.parse_args(argv)


def mcg_candidates(mat_path: str, top_k: int):
    """Yield (mask (H, W) bool, box (4,) f32) for the top_k MCG candidates
    of one image; a candidate whose mask is empty is skipped."""
    from scipy.io import loadmat

    data = loadmat(mat_path)
    superpixels = data["superpixels"]  # (H, W) int labels
    labels = data["labels"].ravel()  # object array of label lists
    for cand in labels[:top_k]:
        mask = np.isin(superpixels, np.asarray(cand).ravel())
        ys, xs = np.where(mask)
        if len(ys) == 0:
            continue
        yield mask, np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def crop_resize(mask: np.ndarray, box: np.ndarray, size: int) -> np.ndarray:
    """The mask's crop to its (inclusive) box, resized to (size, size)."""
    x1, y1, x2, y2 = box.astype(int)
    crop = mask[y1:y2 + 1, x1:x2 + 1].astype(np.float32)
    return resize_mask_area(crop, (size, size))


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(args.image_list) as f:
        ids = [x.strip() for x in f if x.strip()]
    os.makedirs(args.out, exist_ok=True)
    for i, image_id in enumerate(ids):
        mat = osp.join(args.mcg_dir, f"{image_id}.mat")
        if not osp.exists(mat):
            print(f"missing {mat}, skipping")
            continue
        boxes, masks = [], []
        for mask, box in mcg_candidates(mat, args.top_k):
            boxes.append(box)
            masks.append(crop_resize(mask, box, args.mask_size))
        rec = {"index": image_id, "boxes": np.asarray(boxes, np.float32),
               "masks": np.asarray(masks, np.float32)}
        with open(osp.join(args.out, f"{image_id}.pkl"), "wb") as f:
            pickle.dump(rec, f)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(ids)}")
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
