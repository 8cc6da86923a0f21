"""Greedy NMS over padded, score-sorted working sets — port of
``mnc_tpu/ops/nms.py``.

Same selections as the JAX package (and the reference ``cpu_nms``/
``gpu_nms``), batched over any leading dims so one launch serves every
problem of a batch (B images at the proposal stage, B × classes per-class).
A CUDA tensor goes to kernel B (``csrc/nms.cu``: one launch that scans each
problem in chunks of 64 candidates on a thread-block cluster); a CPU tensor
goes to :func:`nms_keep_plain`, the fixpoint formulation of the JAX package's
``nms_fixed``.
"""

from __future__ import annotations

import numpy as np
import torch

from mnc_tpu_torch.ops.bbox import bbox_overlaps


def _f32(x: float) -> float:
    """Thresholds compare in f32 (as a weak-typed scalar does in JAX)."""
    return float(np.float32(x))


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                   top_n: int = 0) -> torch.Tensor:
    """Plain twin of kernel B: (P, K, 4) sorted boxes, (P, K) valid → keep.

    Greedy NMS is the unique fixpoint of keep[j] = valid[j] & ¬∃i<j
    (keep[i] & IoU(i, j) > thresh); iterating from keep = valid converges
    in (suppression-chain depth) steps.  ``top_n`` > 0 keeps only the first
    ``top_n`` keeps of each problem.
    """
    k = boxes.shape[-2]
    iou = bbox_overlaps(boxes, boxes)
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > _f32(thresh)) & upper & valid.unsqueeze(-1)
    keep = valid
    for _ in range(k):
        new = valid & ~(keep.unsqueeze(-1) & sup).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    if top_n > 0:
        keep = keep & (keep.cumsum(-1) <= top_n)
    return keep


def _nms_keep(boxes, valid, thresh, top_n):
    lead = boxes.shape[:-2]
    k = boxes.shape[-2]
    b = boxes.reshape(-1, k, 4).contiguous()
    v = valid.reshape(-1, k).contiguous()
    if boxes.is_cuda:
        from mnc_tpu_torch.kernels import nms_keep_cuda

        keep = nms_keep_cuda(b, v, _f32(thresh), top_n)
    else:
        keep = nms_keep_plain(b, v, thresh, top_n)
    return keep.reshape(*lead, k)


def nms_fixed(boxes: torch.Tensor, valid: torch.Tensor, thresh) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes.

    Args:
      boxes: (..., K, 4), sorted by descending score (ties broken by index).
      valid: (..., K) bool — padding mask; invalid boxes neither keep nor
        suppress.
      thresh: IoU threshold.

    Returns (..., K) bool keep mask (False wherever ``valid`` is False).
    """
    return _nms_keep(boxes, valid, thresh, 0)


def nms_tiled(boxes: torch.Tensor, valid: torch.Tensor, thresh,
              top_n: int) -> torch.Tensor:
    """Greedy NMS whose keep mask holds EXACTLY the first ``top_n`` greedy
    keeps in score order (the JAX ``nms_tiled`` contract).

    The JAX package tiles the scan to bound an O(K²) f32 matrix.  The port's
    kernel holds no matrix at all: it walks the boxes in chunks of 64, compares
    a chunk only with the boxes kept so far (which live in shared memory),
    resolves the chunk's own 64 × 64 tile in registers and stops at the
    ``top_n``-th keep, also in the middle of a chunk; so no tile size is
    needed.
    """
    return _nms_keep(boxes, valid, thresh, int(top_n))


def nms_indices(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    thresh,
    top_n: int,
    chunk: int | None = None,
    presorted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort by score, run NMS, return the top ``top_n`` kept indices.

    Args:
      boxes: (..., K, 4) in any order.
      scores: (..., K).
      valid: (..., K) bool.
      thresh: IoU threshold.
      top_n: static output count (padded with the first index).
      chunk: when set and K > chunk, stop the scan after ``top_n`` keeps
        (:func:`nms_tiled`); the selections are the same either way.
      presorted: inputs are already in descending-score order with invalid
        entries trailing — skips the sort.

    Returns:
      (idx, keep_valid): idx (..., top_n) int64 indices into the ORIGINAL
      arrays in descending-score order; keep_valid (..., top_n) bool.
    """
    k = boxes.shape[-2]
    if presorted:
        order = None
        sorted_boxes, sorted_valid = boxes, valid
    else:
        neg_inf = torch.finfo(scores.dtype).min
        masked = torch.where(valid, scores, torch.full_like(scores, neg_inf))
        # stable: equal scores keep the lower index first, as jnp.argsort
        order = torch.sort(-masked, dim=-1, stable=True).indices
        sorted_boxes = torch.gather(boxes, -2, order.unsqueeze(-1).expand(*order.shape, 4))
        sorted_valid = torch.gather(valid, -1, order)
    if chunk is not None and k > chunk:
        keep = nms_tiled(sorted_boxes, sorted_valid, thresh, top_n)
    else:
        keep = nms_fixed(sorted_boxes, sorted_valid, thresh)

    # the first top_n keeps in rank order, then the non-kept ones in rank
    # order (the JAX package's top_k over -rank, which breaks ties low-first)
    rank = torch.arange(k, device=boxes.device)
    key = torch.where(keep, rank, rank + k)
    top_pos = torch.sort(key, dim=-1, stable=True).indices[..., :top_n]
    keep_valid = torch.gather(keep, -1, top_pos)
    idx = top_pos if order is None else torch.gather(order, -1, top_pos)
    # padding entries point at the first box (always in range)
    idx = torch.where(keep_valid, idx, idx[..., :1])
    return idx, keep_valid
