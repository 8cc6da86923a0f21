"""Host-side helpers — port of ``mnc_tpu/native/__init__.py``, in numpy.

The JAX package binds a small C++ library (``mnc_native.cpp``) with ctypes
and falls back to numpy without a compiler; the port has the numpy versions
only, with the library's semantics: the Caffe +1 box widths, f32 IoUs,
greedy NMS over score-sorted boxes, COCO-style run-length encoding in
column-major order whose first run counts zeros (0 when the first pixel is
set), and host mask voting.  A native copy waits until a measurement shows
that these helpers matter on the host.
"""

from __future__ import annotations

import numpy as np

# one mask IoU for the port: the evaluator's, exact pixel counts
from mnc_tpu_torch.data.eval_sds import mask_iou_matrix  # noqa: F401


def _areas(b: np.ndarray) -> np.ndarray:
    return (b[:, 2] - b[:, 0] + np.float32(1)) * (b[:, 3] - b[:, 1] + np.float32(1))


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, 4) × (K, 4) boxes → (N, K) f32 IoU (0 where they do not meet)."""
    b = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    q = np.ascontiguousarray(query, np.float32).reshape(-1, 4)
    one = np.float32(1)
    iw = np.minimum(b[:, None, 2], q[None, :, 2]) - np.maximum(b[:, None, 0], q[None, :, 0]) + one
    ih = np.minimum(b[:, None, 3], q[None, :, 3]) - np.maximum(b[:, None, 1], q[None, :, 1]) + one
    inter = iw * ih
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / (_areas(b)[:, None] + _areas(q)[None, :] - inter)
    return np.where((iw > 0) & (ih > 0), iou, np.float32(0)).astype(np.float32)


def cpu_nms(sorted_boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Keep mask over score-sorted boxes (reference ``cpu_nms`` semantics)."""
    b = np.ascontiguousarray(sorted_boxes, np.float32).reshape(-1, 4)
    keep = np.ones(len(b), bool)
    t = np.float32(thresh)
    for i in range(len(b)):
        if keep[i]:
            keep[i + 1:] &= ~(bbox_overlaps(b[i:i + 1], b[i + 1:])[0] > t)
    return keep


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask (set where > 0.5) → {"size": (H, W), "counts":
    int32 run lengths}, column-major like pycocotools."""
    h, w = mask.shape
    flat = (np.asarray(mask) > 0.5).T.reshape(-1).astype(np.int8)
    if flat.size == 0:
        return {"size": (h, w), "counts": np.zeros(1, np.int32)}
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"size": (h, w), "counts": runs.astype(np.int32)}


def rle_decode(rle: dict) -> np.ndarray:
    """Inverse of :func:`rle_encode` → (H, W) uint8; runs past H·W are cut,
    pixels past the last run stay 0."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    flat = np.repeat((np.arange(len(counts)) % 2).astype(np.uint8), counts)[:h * w]
    flat = np.concatenate([flat, np.zeros(h * w - len(flat), np.uint8)])
    return np.ascontiguousarray(flat.reshape(w, h).T)


def _hats(coords: np.ndarray, size: int) -> np.ndarray:
    """(..., P) sample coordinates → (..., P, size) bilinear tap weights,
    zero outside [0, size)."""
    d = coords[..., None] - np.arange(size, dtype=np.float32)
    return np.maximum(np.float32(0), np.float32(1) - np.abs(d)).astype(np.float32)


def mask_voting_cpu(kept_boxes, cand_boxes, scores, masks, iou_thresh=0.5):
    """Host mask voting (the oracle of the on-device version): each kept
    box averages the candidate soft masks (M, M) whose box overlaps it by
    IoU >= ``iou_thresh`` and whose score is > 0, each resampled bilinearly
    from its own box frame into the kept frame, weighted by score.
    Returns (K, M, M) f32."""
    kept = np.ascontiguousarray(kept_boxes, np.float32).reshape(-1, 4)
    cand = np.ascontiguousarray(cand_boxes, np.float32).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    ms = masks.shape[-1]
    f1 = np.float32(1)
    iou = bbox_overlaps(kept, cand)
    grid = (np.arange(ms, dtype=np.float32) + np.float32(0.5)) / np.float32(ms)
    cw = np.maximum(cand[:, 2] - cand[:, 0] + f1, f1)
    ch = np.maximum(cand[:, 3] - cand[:, 1] + f1, f1)
    out = np.zeros((len(kept), ms, ms), np.float32)
    for i, kb in enumerate(kept):
        sel = np.flatnonzero((iou[i] >= np.float32(iou_thresh)) & (scores > 0))
        if not len(sel):
            continue
        imy = kb[1] + grid * (kb[3] - kb[1] + f1)
        imx = kb[0] + grid * (kb[2] - kb[0] + f1)
        sy = (imy[None] - cand[sel, 1:2]) / ch[sel, None] * np.float32(ms) - np.float32(0.5)
        sx = (imx[None] - cand[sel, 0:1]) / cw[sel, None] * np.float32(ms) - np.float32(0.5)
        votes = _hats(sy, ms) @ masks[sel] @ _hats(sx, ms).transpose(0, 2, 1)
        acc = np.zeros((ms, ms), np.float32)
        for s, v in zip(scores[sel], votes):
            acc += s * v
        out[i] = acc / scores[sel].sum(dtype=np.float32)
    return out
