"""Mask-target fidelity against exact full-resolution crops — the port's
counterpart of ``tools/mask_fidelity_study.py``.

Ground-truth masks are stored cropped to their gt box at a fixed S×S
resolution (the maskdb convention) and later resampled to the M×M RoI
target by ``intersect_mask``: two lossy resamples where the reference
cropped the full-resolution mask per RoI.  This measures the error that
chain introduces, per stored resolution S and downsample filter, against
targets computed directly from the full-resolution mask:

    python3 -m mnc_tpu_torch.tools.mask_fidelity_study [--trials 200] [--mask-size 21] \\
        [--canvas 640 1024] [--device cpu]

Output: the mean, 5th percentile and minimum IoU between the pipeline's
targets and the exact ones for each (S, filter), S in 28, 56, 112 and 224,
as a table: the basis of the ``gt_mask_size`` default.  The ``area``
filter is ``utils/blob.py::resize_mask_area`` (cv2's INTER_AREA to f32
rounding), so the tool runs without cv2; ``intersect_mask`` runs on
``--device`` (the GPU unless ``--device cpu`` is given; it raises without
one).
"""

from __future__ import annotations

import argparse

import numpy as np

SIZES = (28, 56, 112, 224)
FILTERS = ("nearest", "area")


def exact_target(full_mask, gt_box, roi, m):
    """Reference-style target: sample the FULL-RES mask at the RoI's m×m bin
    centers (nearest), zero outside the gt box."""
    x1, y1, x2, y2 = gt_box
    rh = roi[3] - roi[1] + 1.0
    rw = roi[2] - roi[0] + 1.0
    ys = roi[1] + (np.arange(m) + 0.5) / m * rh - 0.5
    xs = roi[0] + (np.arange(m) + 0.5) / m * rw - 0.5
    yy = np.round(ys).astype(int)
    xx = np.round(xs).astype(int)
    h, w = full_mask.shape
    inside_y = (yy >= y1) & (yy <= y2) & (yy >= 0) & (yy < h)
    inside_x = (xx >= x1) & (xx <= x2) & (xx >= 0) & (xx < w)
    t = full_mask[np.clip(yy, 0, h - 1)[:, None], np.clip(xx, 0, w - 1)[None, :]]
    return (t * inside_y[:, None] * inside_x[None, :]).astype(np.float32)


def store_cropped(full_mask, gt_box, s, filt):
    """maskdb storage step: crop to gt box, resize to (s, s)."""
    from mnc_tpu_torch.utils.blob import resize_mask_area

    x1, y1, x2, y2 = [int(v) for v in gt_box]
    crop = full_mask[y1:y2 + 1, x1:x2 + 1].astype(np.float32)
    if filt == "nearest":
        ys = np.clip(((np.arange(s) + 0.5) * crop.shape[0] / s).astype(int),
                     0, crop.shape[0] - 1)
        xs = np.clip(((np.arange(s) + 0.5) * crop.shape[1] / s).astype(int),
                     0, crop.shape[1] - 1)
        return crop[np.ix_(ys, xs)]
    return resize_mask_area(crop, (s, s))


def iou(a, b):
    inter = np.logical_and(a > 0.5, b > 0.5).sum()
    union = np.logical_or(a > 0.5, b > 0.5).sum()
    return inter / union if union else 1.0


def make_cases(trials: int, canvas, seed: int = 0) -> list:
    """(full mask, gt box, fg RoI) per trial: a shape of ``_render_shape``
    at a random place and size, and a jittered copy of its box (IoU >= ~0.5,
    like sampled positives), drawn from ``RandomState(seed)``."""
    from mnc_tpu_torch.data.synthetic import _render_shape

    rs = np.random.RandomState(seed)
    h, w = canvas
    cases = []
    for _ in range(trials):
        kind = rs.randint(0, 5)
        bw = rs.randint(max(12, w // 10), w // 2)
        bh = rs.randint(max(12, h // 10), h // 2)
        x1 = rs.randint(0, w - bw)
        y1 = rs.randint(0, h - bh)
        full = np.zeros((h, w), np.float32)
        full[y1:y1 + bh, x1:x1 + bw] = _render_shape(kind, bh, bw)
        gt = np.array([x1, y1, x1 + bw - 1, y1 + bh - 1], np.float32)
        jit = rs.uniform(-0.2, 0.2, 4) * [bw, bh, bw, bh]
        roi = np.array([max(0, gt[0] + jit[0]), max(0, gt[1] + jit[1]),
                        min(w - 1, gt[2] + jit[2]), min(h - 1, gt[3] + jit[3])],
                       np.float32)
        cases.append((full, gt, roi))
    return cases


def fidelity(cases, m: int, device) -> dict:
    """{(S, filter): the IoUs of the pipeline's targets (stored at S by the
    filter, then ``intersect_mask`` to m×m) against the exact targets}."""
    import torch

    from mnc_tpu_torch.ops.masks import intersect_mask

    exact = np.stack([exact_target(f, g, r, m) for f, g, r in cases])
    rois = torch.as_tensor(np.stack([r for _, _, r in cases]), device=device)
    gts = torch.as_tensor(np.stack([g for _, g, _ in cases]), device=device)
    out = {}
    for s in SIZES:
        for filt in FILTERS:
            stored = np.stack([store_cropped(f, g, s, filt) for f, g, _ in cases])
            got = intersect_mask(rois, gts, torch.as_tensor(stored, device=device), m)
            out[s, filt] = np.array([iou(a, b) for a, b in zip(got.cpu().numpy(), exact)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="mask-target fidelity study (PyTorch port)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--mask-size", type=int, default=21)
    ap.add_argument("--canvas", type=int, nargs=2, default=(640, 1024))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    h, w = args.canvas
    m = args.mask_size
    ious = fidelity(make_cases(args.trials, (h, w)), m, device)
    print(f"{args.trials} shapes on {h}x{w}, mask_size {m}; "
          f"IoU of pipeline target vs exact full-res target:")
    print(f"{'S':>5} {'filter':>8} {'meanIoU':>8} {'p5':>7} {'min':>7}")
    for (s, filt), v in ious.items():
        print(f"{s:>5} {filt:>8} {v.mean():8.4f} {np.percentile(v, 5):7.4f} {v.min():7.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
