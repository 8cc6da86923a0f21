"""Mask and box voting per detection — port of the post-top-K half of
``mnc_tpu/ops/mask_voting.py`` (≙ reference ``lib/nms/mv.pyx``).

Each kept detection averages the soft masks of its candidates whose box IoU
with it is ≥ the threshold, weighted by candidate score, with each
candidate mask resampled from its own box frame into the kept box's frame.
Plain PyTorch in f32 on either device (the JAX package runs these products
at ``precision="highest"``).
"""

from __future__ import annotations

import torch

from mnc_tpu_torch.ops.bbox import bbox_overlaps
from mnc_tpu_torch.ops.roi_warp import interp_matrix


def _frame_coords(dst_boxes: torch.Tensor, src_boxes: torch.Tensor, m: int):
    """dst (..., 4) × src (..., 4) → (cy, cx), each (..., M): coords of the
    dst-frame bin centers in the src mask's pixel space."""
    grid = (torch.arange(m, dtype=torch.float32, device=dst_boxes.device) + 0.5) / m

    def axis(lo_d, hi_d, lo_s, hi_s):
        span_d = hi_d - lo_d + 1.0
        span_s = (hi_s - lo_s + 1.0).clamp_min(1.0)
        img = lo_d.unsqueeze(-1) + grid * span_d.unsqueeze(-1)
        return (img - lo_s.unsqueeze(-1)) / span_s.unsqueeze(-1) * m - 0.5

    cy = axis(dst_boxes[..., 1], dst_boxes[..., 3], src_boxes[..., 1], src_boxes[..., 3])
    cx = axis(dst_boxes[..., 0], dst_boxes[..., 2], src_boxes[..., 0], src_boxes[..., 2])
    return cy, cx


def _resample_to_frame(masks: torch.Tensor, src_boxes: torch.Tensor,
                       dst_boxes: torch.Tensor) -> torch.Tensor:
    """Resample (..., M, M) masks living in src-box frames onto the dst
    boxes' grids: wy @ mask @ wxᵀ per pair."""
    m = masks.shape[-1]
    cy, cx = _frame_coords(dst_boxes, src_boxes, m)
    wy = interp_matrix(cy, m)  # (..., M, M)
    wx = interp_matrix(cx, m)
    return wy @ masks.float() @ wx.transpose(-1, -2)


def _neighbor_weights(kept_boxes, cand_boxes, cand_scores, iou_thresh):
    iou = bbox_overlaps(kept_boxes.unsqueeze(-2), cand_boxes).squeeze(-2)  # (N, Cv)
    return torch.where(iou >= iou_thresh, cand_scores.float(),
                       torch.zeros((), device=iou.device))


def box_voting_per_det(kept_boxes: torch.Tensor, cand_boxes: torch.Tensor,
                       cand_scores: torch.Tensor, iou_thresh: float = 0.5) -> torch.Tensor:
    """kept_boxes (N, 4), cand_boxes (N, Cv, 4), cand_scores (N, Cv) →
    (N, 4) score-weighted neighbor-average boxes (a box with no neighbor
    weight stays as it is)."""
    w = _neighbor_weights(kept_boxes, cand_boxes, cand_scores, iou_thresh)
    den = w.sum(1)
    num = torch.einsum("nc,ncd->nd", w, cand_boxes.float())
    return torch.where(den.unsqueeze(1) > 1e-8, num / den.clamp_min(1e-8).unsqueeze(1),
                       kept_boxes.float())


def mask_voting_per_det(kept_boxes: torch.Tensor, cand_boxes: torch.Tensor,
                        cand_scores: torch.Tensor, cand_masks: torch.Tensor,
                        iou_thresh: float = 0.5) -> torch.Tensor:
    """Voting with a per-detection candidate set.

    Args:
      kept_boxes: (N, 4).
      cand_boxes: (N, Cv, 4) candidates per kept det.
      cand_scores: (N, Cv) — zero entries are ignored.
      cand_masks: (N, Cv, M, M).
      iou_thresh: neighbor threshold.

    Returns (N, M, M) merged soft masks in the kept boxes' frames.
    """
    w = _neighbor_weights(kept_boxes, cand_boxes, cand_scores, iou_thresh)
    stacks = _resample_to_frame(cand_masks, cand_boxes,
                                kept_boxes.unsqueeze(1).expand_as(cand_boxes))
    num = torch.einsum("nc,ncpq->npq", w, stacks)
    den = w.sum(1).clamp_min(1e-8)
    return num / den[:, None, None]
