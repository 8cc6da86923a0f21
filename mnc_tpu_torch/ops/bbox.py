"""Box geometry — port of ``mnc_tpu/ops/bbox.py``.

Behavioral port of the reference ``lib/transform/bbox_transform.py``
(bbox_transform, bbox_transform_inv, clip_boxes) and ``lib/utils/cython_bbox.pyx``
(bbox_overlaps), preserving the Caffe pixel convention (w = x2 - x1 + 1).
Every expression keeps the JAX package's order of operations, so f32 results
agree to the last bit where the backends round alike.  Clamps are written
as ``torch.maximum``/``torch.minimum`` against a tensor: at a tie these
split the gradient in halves, as ``jnp.maximum``/``jnp.clip`` do, where
``Tensor.clamp`` would pass all of it.
"""

from __future__ import annotations

import torch


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Regression targets (dx, dy, dw, dh) that map ex_rois onto gt_rois.
    (..., 4), (..., 4) -> (..., 4); differentiable in both."""
    one = ex_rois.new_ones(())
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    # guard against degenerate (padded) boxes: clamp sizes to >= 1
    ex_w = torch.maximum(ex_w, one)
    ex_h = torch.maximum(ex_h, one)
    gt_w = torch.maximum(gt_w, one)
    gt_h = torch.maximum(gt_h, one)

    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w / ex_w)
    dh = torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply regression deltas to boxes.  (..., 4), (..., 4) -> (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx, dy, dw, dh = deltas.unbind(-1)
    # clamp dw/dh against exp overflow on padded garbage
    lim = deltas.new_full((), 8.0)
    dw = torch.minimum(torch.maximum(dw, -lim), lim)
    dh = torch.minimum(torch.maximum(dh, -lim), lim)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w - 1.0,
            pred_cy + 0.5 * pred_h - 1.0,
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, im_hw) -> torch.Tensor:
    """Clip boxes to the image: x in [0, W-1], y in [0, H-1].

    ``im_hw`` is (h, w): numbers, or tensors that broadcast against
    ``boxes[..., 0]`` (e.g. ``im_info[:, 0:1]`` for a batch).
    """
    h, w = im_hw
    zero = boxes.new_zeros(())

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), torch.as_tensor(
            hi - 1.0, dtype=boxes.dtype, device=boxes.device))

    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], dim=-1)


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., N, K) between boxes (..., N, 4) and query_boxes
    (..., K, 4), with +1 widths and the union clamped to >= 1."""
    b = boxes.unsqueeze(-2)  # (..., N, 1, 4)
    q = query_boxes.unsqueeze(-3)  # (..., 1, K, 4)
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0
    iw = iw.clamp_min(0.0)
    ih = ih.clamp_min(0.0)
    inter = iw * ih
    union = bbox_area(boxes).unsqueeze(-1) + bbox_area(query_boxes).unsqueeze(-2) - inter
    return inter / union.clamp_min(1.0)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) indexed per batch row by idx (B, ...) → (B, ..., ...)."""
    bidx = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[bidx, idx]
