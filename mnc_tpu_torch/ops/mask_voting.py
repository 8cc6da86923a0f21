"""Mask and box voting — port of ``mnc_tpu/ops/mask_voting.py`` (≙ reference
``lib/nms/mv.pyx``).

Each kept detection averages the soft masks of its candidates whose box IoU
with it is ≥ the threshold, weighted by candidate score, with each
candidate mask resampled from its own box frame into the kept box's frame.
:func:`mask_voting` and :func:`box_voting` vote over one class's whole
candidate set (the candidates in chunks, summed into one (N, M, M) buffer in
the order of the JAX package's ``lax.scan``); the ``_per_det`` pair votes
each detection over its own candidates (the post-top-K path of the
pipeline).  The resample is the hat-matrix product (``"einsum"``) or the
separable 2-tap gather (``"gather"``, ``TEST.VOTE_IMPL``): the same math to
f32 rounding.  Plain PyTorch in f32 on either device (the JAX package runs
these products at ``precision="highest"``).
"""

from __future__ import annotations

import torch

from mnc_tpu_torch.ops.bbox import bbox_overlaps
from mnc_tpu_torch.ops.roi_warp import interp_matrix


def _frame_coords(dst_boxes: torch.Tensor, src_boxes: torch.Tensor, m: int):
    """dst (..., 4) × src (..., 4) → (cy, cx), each (..., M): coords of the
    dst-frame bin centers in the src mask's pixel space, broadcasting the
    leading dims (the JAX package's ``_frame_coords_batched``)."""
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


def _lerp_taps(coords: torch.Tensor, size: int):
    """2-tap hat sampling: ((idx_lo, w_lo), (idx_hi, w_hi)) for coords (...).

    A hat-matrix row (:func:`interp_matrix`) has at most two nonzeros, the
    floor and ceil taps with weights (1 - f, f), and none for a tap outside
    [0, size): the same math without building the matrix."""
    lo = torch.floor(coords)
    f = coords - lo
    lo_i = lo.to(torch.int64)
    zero = coords.new_zeros(())
    w_lo = torch.where((lo_i >= 0) & (lo_i < size), 1.0 - f, zero)
    w_hi = torch.where((lo_i + 1 >= 0) & (lo_i + 1 < size), f, zero)
    return ((lo_i.clamp(0, size - 1), w_lo), ((lo_i + 1).clamp(0, size - 1), w_hi))


def _resample_gather(masks: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
    """Separable 2-tap resample: masks (..., S, S) sampled at cy, cx (..., M)
    → (..., M, M), with ``torch.gather`` (JAX: ``take_along_axis``).  Equal
    to the hat-matrix product to f32 rounding, with O(M·S) work a pair
    instead of O(M·S²)."""
    s = masks.shape[-1]
    m = cy.shape[-1]
    vals = masks.float()
    (yl, wyl), (yh, wyh) = _lerp_taps(cy, s)

    def rows_at(idx):  # vals[..., idx[..., p], t] → (..., M, S)
        return torch.gather(vals, -2, idx.unsqueeze(-1).expand(*idx.shape, s))

    rows = rows_at(yl) * wyl.unsqueeze(-1) + rows_at(yh) * wyh.unsqueeze(-1)
    (xl, wxl), (xh, wxh) = _lerp_taps(cx, s)

    def cols_at(idx):  # rows[..., p, idx[..., q]] → (..., M, M)
        return torch.gather(rows, -1, idx.unsqueeze(-2).expand(*idx.shape[:-1], m, m))

    return cols_at(xl) * wxl.unsqueeze(-2) + cols_at(xh) * wxh.unsqueeze(-2)


def mask_voting(kept_boxes: torch.Tensor, cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                cand_masks: torch.Tensor, cand_valid: torch.Tensor, iou_thresh: float = 0.5,
                chunk: int = 32) -> torch.Tensor:
    """Score-weighted mask averaging over IoU neighbors, for one class.

    Args:
      kept_boxes: (N, 4) NMS survivors (image coordinates).
      cand_boxes: (K, 4) all candidates of the same class.
      cand_scores: (K,).
      cand_masks: (K, M, M) soft masks in their own box frames.
      cand_valid: (K,) bool padding mask.
      iou_thresh: neighbor threshold (reference MASK_MERGE_IOU_THRESH 0.5).
      chunk: candidates resampled at a time; K is padded to a multiple of
        it with unit boxes of zero weight, and the chunks are summed in
        order into one (N, M, M) f32 buffer (peak temporaries O(N · chunk ·
        M²)), as the JAX package's scan sums them.

    Returns (N, M, M) f32 merged soft masks in the kept boxes' frames.
    """
    n, k, m = kept_boxes.shape[0], cand_boxes.shape[0], cand_masks.shape[-1]
    iou = bbox_overlaps(kept_boxes, cand_boxes)  # (N, K)
    w = torch.where((iou >= iou_thresh) & cand_valid[None, :], cand_scores.float(),
                    iou.new_zeros(()))
    pad = (-k) % chunk
    if pad:
        cand_boxes = torch.cat([cand_boxes, cand_boxes.new_ones((pad, 4))])
        cand_masks = torch.cat([cand_masks, cand_masks.new_zeros((pad, m, m))])
        w = torch.cat([w, w.new_zeros((n, pad))], 1)
    acc = w.new_zeros((n, m, m))
    for s in range(0, k + pad, chunk):
        bc, mc, wc = cand_boxes[s:s + chunk], cand_masks[s:s + chunk], w[:, s:s + chunk]
        r = _resample_to_frame(mc.expand(n, *mc.shape), bc.expand(n, *bc.shape),
                               kept_boxes[:, None].expand(n, chunk, 4))  # (N, chunk, M, M)
        acc = acc + torch.einsum("nc,ncpq->npq", wc, r)
    den = w.sum(1).clamp_min(1e-8)
    return acc / den[:, None, None]


def box_voting(kept_boxes: torch.Tensor, cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
               cand_valid: torch.Tensor | None = None, iou_thresh: float = 0.5) -> torch.Tensor:
    """Score-weighted box averaging over IoU neighbors, for one class: each
    kept box (N, 4) becomes the mean of the candidate boxes (K, 4) with IoU
    ≥ ``iou_thresh`` against it, weighted by their scores (K,); ``cand_valid``
    (K,) bool masks padding (None: all valid).  A box without neighbor
    weight stays as it is.  Returns (N, 4) f32."""
    iou = bbox_overlaps(kept_boxes, cand_boxes)  # (N, K)
    w = torch.where(iou >= iou_thresh, cand_scores.float(), iou.new_zeros(()))
    if cand_valid is not None:
        w = torch.where(cand_valid[None, :], w, w.new_zeros(()))
    den = w.sum(1)
    num = w @ cand_boxes.float()  # (N, 4)
    return torch.where(den[:, None] > 1e-8, num / den.clamp_min(1e-8)[:, None],
                       kept_boxes.float())


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
                        iou_thresh: float = 0.5, impl: str = "einsum") -> torch.Tensor:
    """Voting with a per-detection candidate set.

    Args:
      kept_boxes: (N, 4).
      cand_boxes: (N, Cv, 4) candidates per kept det.
      cand_scores: (N, Cv) — zero entries are ignored.
      cand_masks: (N, Cv, M, M).
      iou_thresh: neighbor threshold.
      impl: "einsum" (per-pair hat products) or "gather" (the separable
        2-tap gather, :func:`_resample_gather`).

    Returns (N, M, M) merged soft masks in the kept boxes' frames.
    """
    w = _neighbor_weights(kept_boxes, cand_boxes, cand_scores, iou_thresh)
    if impl == "gather":
        cy, cx = _frame_coords(kept_boxes.unsqueeze(1), cand_boxes, cand_masks.shape[-1])
        stacks = _resample_gather(cand_masks, cy, cx)  # (N, Cv, M, M)
    elif impl == "einsum":
        stacks = _resample_to_frame(cand_masks, cand_boxes,
                                    kept_boxes.unsqueeze(1).expand_as(cand_boxes))
    else:
        raise ValueError(f"unknown vote impl {impl!r} (einsum or gather)")
    num = torch.einsum("nc,ncpq->npq", w, stacks)
    den = w.sum(1).clamp_min(1e-8)
    return num / den[:, None, None]
