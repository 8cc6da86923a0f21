"""Training target assignment on the device — port of
``mnc_tpu/train/targets.py``.

Fixed-shape, masked forms of the reference's dynamic-shape Python layers:

- :func:`anchor_targets` ≙ ``lib/pylayer/anchor_target_layer.py`` — RPN
  labels and regression targets over all anchors with random fg/bg
  subsampling.
- :func:`proposal_targets` ≙ ``lib/pylayer/proposal_target_layer.py`` —
  sample a fixed RoI batch (fg quota + bg fill), assign class labels,
  normalized bbox deltas and MASK_SIZE² mask targets.
- :func:`reassign_targets` ≙ the target half of
  ``lib/pylayer/stage_bridge_layer.py`` — recompute the targets of the
  bridge-refined RoIs for the second pass (no re-sampling).
- :func:`cfm_targets` — the same sampling over a pool of precomputed
  segment proposals (the CFM path, ``models/cfm.py``), labelled by box IoU
  or, with ``iou_mode="mask"``, by mask IoU (:func:`_assign_mask_iou`).

Each works on ONE image (the train step loops over the images of a batch,
so every image keeps its own draws).  Random subsampling ranks uniform
draws; the draws are an ARGUMENT (one tensor per selection), so a caller
can feed the JAX package's own draws and get its selections.  Every
selection breaks ties to the lower index (stable sorts, a first-index
argmax), on the card as on the CPU.  As in the JAX package the box targets
are differentiable functions of the sampled RoIs (no ``detach``); the mask
targets are binarized and carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mnc_tpu_torch.ops.bbox import bbox_overlaps, bbox_transform
from mnc_tpu_torch.ops.masks import intersect_mask


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (K,) int32 in {-1 ignore, 0 bg, 1 fg}
    bbox_targets: torch.Tensor  # (K, 4)
    bbox_inside_w: torch.Tensor  # (K, 4)
    bbox_outside_w: torch.Tensor  # (K, 4)


class RoiTargets(NamedTuple):
    rois: torch.Tensor  # (R, 4) sampled boxes
    labels: torch.Tensor  # (R,) int32 in {-1 pad, 0 bg, 1..C-1 fg class}
    bbox_targets: torch.Tensor  # (R, 4) normalized deltas to the matched gt
    bbox_weight: torch.Tensor  # (R,) 1.0 for fg
    mask_targets: torch.Tensor  # (R, M, M) binary
    mask_weight: torch.Tensor  # (R,) 1.0 for fg


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last dim (as ``jnp.argmax``),
    written as a min over indices so that no backend's tie rule matters."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    top = x.max(dim=-1, keepdim=True).values
    return torch.where(x == top, idx, idx.new_full((), n)).min(dim=-1).values


def _random_keep(r: torch.Tensor, eligible: torch.Tensor, quota, max_quota: int) -> torch.Tensor:
    """``eligible & (rank of r among the eligible < quota)``.

    r (K,) uniform draws in [0, 1); ``quota`` an int or a 0-dim tensor,
    ``max_quota`` its static upper bound.  Equal draws rank by index.
    """
    r = torch.where(eligible, r, r.new_full((), 2.0))  # ineligible to the back
    k = min(int(max_quota), r.shape[0])
    idx = torch.sort(r, stable=True).indices[:k]  # k smallest, in rank order
    keep = torch.zeros_like(eligible)
    keep[idx] = torch.arange(k, device=r.device) < quota
    return keep & eligible


def anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   im_hw, draws, pos_overlap: float = 0.7, neg_overlap: float = 0.3,
                   batch_size: int = 256, fg_fraction: float = 0.5,
                   clobber_positives: bool = False, positive_weight: float = -1.0,
                   inside_weights=(1.0, 1.0, 1.0, 1.0)) -> AnchorTargets:
    """RPN training targets over the full anchor grid (K anchors).

    Only anchors fully inside the (scaled) image take part; positives are
    the per-gt argmax anchors (all ties) and anchors with IoU >= pos_overlap;
    negatives have max IoU < neg_overlap; both sides are subsampled to
    ``batch_size`` anchors with at most ``fg_fraction`` positives.  ``draws``
    is the pair of (K,) uniform tensors that rank the positives and the
    negatives.
    """
    k = anchors.shape[0]
    h, w = im_hw
    r_pos, r_neg = draws
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < w) & (anchors[:, 3] < h))
    zero = anchors.new_zeros(())

    overlaps = bbox_overlaps(anchors, gt_boxes)  # (K, G)
    overlaps = torch.where(gt_valid[None, :], overlaps, zero)
    overlaps = torch.where(inside[:, None], overlaps, zero)
    max_ov = overlaps.max(dim=1).values
    argmax_gt = first_argmax(overlaps)

    gt_max = overlaps.max(dim=0).values  # (G,)
    is_gt_argmax = ((overlaps == gt_max[None, :]) & (gt_max[None, :] > 0)
                    & gt_valid[None, :]).any(dim=1)

    pos = inside & (is_gt_argmax | (max_ov >= pos_overlap))
    neg = inside & (max_ov < neg_overlap)
    if clobber_positives:
        pos = pos & ~neg
    else:
        neg = neg & ~pos

    num_fg = int(batch_size * fg_fraction)
    pos_keep = _random_keep(r_pos, pos, num_fg, num_fg)
    n_pos = pos_keep.sum()
    neg_keep = _random_keep(r_neg, neg, batch_size - n_pos, batch_size)
    n_neg = neg_keep.sum()

    labels = torch.where(pos_keep, 1, torch.where(neg_keep, 0, -1)).to(torch.int32)

    bbox_targets = bbox_transform(anchors, gt_boxes[argmax_gt])
    bbox_targets = torch.where(pos_keep[:, None], bbox_targets, zero)
    inside_w = torch.where(pos_keep[:, None], anchors.new_tensor(inside_weights), zero)
    one = anchors.new_ones(())
    if positive_weight > 0:
        # p in (0, 1): the positives share p, the negatives 1 - p
        wp = positive_weight / torch.maximum(n_pos.float(), one)
        wn = (1.0 - positive_weight) / torch.maximum(n_neg.float(), one)
        outside = (torch.where(pos_keep, wp, zero) + torch.where(neg_keep, wn, zero))
    else:
        # uniform 1/N_batch over all sampled anchors
        uniform = 1.0 / torch.maximum((n_pos + n_neg).float(), one)
        outside = torch.where(pos_keep | neg_keep, uniform, zero)
    return AnchorTargets(labels, bbox_targets, inside_w, outside[:, None].expand(k, 4))


def _assign(rois, gt_boxes, gt_classes, gt_valid, fg_thresh):
    """Match rois to gt: (max overlap, matched index, box, class, fg mask)."""
    overlaps = bbox_overlaps(rois, gt_boxes)
    overlaps = torch.where(gt_valid[None, :], overlaps, overlaps.new_zeros(()))
    max_ov = overlaps.max(dim=1).values
    arg = first_argmax(overlaps)
    return max_ov, arg, gt_boxes[arg], gt_classes[arg], max_ov >= fg_thresh


def _normalized_deltas(rois, boxes, means, stds):
    deltas = bbox_transform(rois, boxes)
    return (deltas - rois.new_tensor(means)) / rois.new_tensor(stds)


def proposal_targets(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                     gt_masks: torch.Tensor, draws, roi_batch: int = 128,
                     fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                     bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.0,
                     mask_size: int = 21, bbox_means=(0.0, 0.0, 0.0, 0.0),
                     bbox_stds=(0.1, 0.1, 0.2, 0.2)) -> RoiTargets:
    """Sample a fixed (roi_batch,) RoI training batch with full targets.

    The gt boxes join the proposal set before sampling.  When the pool
    (N + G) is smaller than ``roi_batch`` it is padded with invalid zero
    boxes; padding slots carry label -1 and zero weights.  ``draws`` is the
    pair of (pool size,) uniform tensors that rank the fg and the bg
    candidates (see :func:`proposal_pool_size`).
    """
    r_fg, r_bg = draws
    all_rois = torch.cat([rois, gt_boxes], dim=0)
    all_valid = torch.cat([roi_valid, gt_valid], dim=0)
    if all_rois.shape[0] < roi_batch:  # tiny configs: pad the pool itself
        pad = roi_batch - all_rois.shape[0]
        all_rois = torch.cat([all_rois, all_rois.new_zeros(pad, 4)], dim=0)
        all_valid = torch.cat([all_valid, all_valid.new_zeros(pad)], dim=0)

    max_ov, arg, mboxes, mcls, fg = _assign(all_rois, gt_boxes, gt_classes, gt_valid,
                                            fg_thresh)
    fg = fg & all_valid
    bg = all_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo) & ~fg

    fg_quota = int(round(roi_batch * fg_fraction))
    fg_keep = _random_keep(r_fg, fg, fg_quota, fg_quota)
    n_fg = fg_keep.sum()
    bg_keep = _random_keep(r_bg, bg, roi_batch - n_fg, roi_batch)

    # gather the kept rois into a dense (roi_batch,) block: fg, then bg, then
    # the rest, each in index order
    sel_key = fg_keep.to(torch.int8) * 2 + bg_keep.to(torch.int8)
    idx = torch.sort(sel_key, descending=True, stable=True).indices[:roi_batch]
    picked_fg = fg_keep[idx]
    picked_bg = bg_keep[idx]

    s_rois = all_rois[idx]
    zero = s_rois.new_zeros(())
    labels = torch.where(picked_fg, mcls[idx].to(torch.int32),
                         torch.where(picked_bg, 0, -1).to(torch.int32))
    deltas = _normalized_deltas(s_rois, mboxes[idx], bbox_means, bbox_stds)
    bbox_targets = torch.where(picked_fg[:, None], deltas, zero)
    bbox_weight = picked_fg.to(torch.float32)

    m_targets = intersect_mask(s_rois.detach(), mboxes[idx], gt_masks[arg[idx]], mask_size)
    m_targets = torch.where(picked_fg[:, None, None], m_targets, zero)
    return RoiTargets(s_rois, labels, bbox_targets, bbox_weight, m_targets, bbox_weight)


def proposal_pool_size(n_rois: int, n_gt: int, roi_batch: int) -> int:
    """Length of each of :func:`proposal_targets`' two draw tensors."""
    return max(n_rois + n_gt, roi_batch)


def reassign_targets(rois: torch.Tensor, prev_labels: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                     gt_masks: torch.Tensor, fg_thresh: float = 0.5, mask_size: int = 21,
                     bbox_means=(0.0, 0.0, 0.0, 0.0),
                     bbox_stds=(0.1, 0.1, 0.2, 0.2)) -> RoiTargets:
    """Recompute targets for bridge-refined RoIs (stages 4-5); no
    re-sampling.  RoIs that were padding (-1) stay padding; the others are
    re-labeled fg/bg by their refined overlap, with fresh box and mask
    targets against the newly matched gt."""
    valid = prev_labels >= 0
    _, arg, mboxes, mcls, fg = _assign(rois, gt_boxes, gt_classes, gt_valid, fg_thresh)
    fg = fg & valid
    zero = rois.new_zeros(())
    labels = torch.where(fg, mcls.to(torch.int32), torch.where(valid, 0, -1).to(torch.int32))
    deltas = _normalized_deltas(rois, mboxes, bbox_means, bbox_stds)
    bbox_targets = torch.where(fg[:, None], deltas, zero)
    w = fg.to(torch.float32)
    m_targets = intersect_mask(rois.detach(), mboxes, gt_masks[arg], mask_size)
    m_targets = torch.where(fg[:, None, None], m_targets, zero)
    return RoiTargets(rois, labels, bbox_targets, w, m_targets, w)


def _assign_mask_iou(rois, roi_masks, gt_boxes, gt_classes, gt_valid, gt_masks, fg_thresh):
    """:func:`_assign` by MASK IoU (``TRAIN.CFM_IOU "mask"``): each proposal
    carries its own (S, S) mask in its box frame.  The IoU with each gt
    instance is counted in image pixels: areas are the binary mask's
    fraction times the box area (+1 convention), the intersection resamples
    the gt mask into the proposal's frame (``intersect_mask``, all gt at
    once)."""
    s = roi_masks.shape[-1]
    n, g = rois.shape[0], gt_boxes.shape[0]

    def area(boxes):
        return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)

    rbin = roi_masks > 0.5
    roi_px = rbin.float().mean(dim=(-2, -1)) * area(rois)  # (N,)
    gt_px = (gt_masks > 0.5).float().mean(dim=(-2, -1)) * area(gt_boxes)  # (G,)
    proj = intersect_mask(rois.expand(g, n, 4), gt_boxes[:, None].expand(g, n, 4),
                          gt_masks[:, None].expand(g, n, *gt_masks.shape[-2:]), s)
    inter = ((rbin & (proj > 0.5)).float().mean(dim=(-2, -1)) * area(rois)).T  # (N, G)
    union = roi_px[:, None] + gt_px[None, :] - inter
    overlaps = inter / torch.clamp_min(union, 1.0)
    overlaps = torch.where(gt_valid[None, :], overlaps, overlaps.new_zeros(()))
    max_ov = overlaps.max(dim=1).values
    arg = first_argmax(overlaps)
    return max_ov, arg, gt_boxes[arg], gt_classes[arg], max_ov >= fg_thresh


class CfmTargets(NamedTuple):
    rois: torch.Tensor  # (R, 4) sampled segment boxes
    labels: torch.Tensor  # (R,) int32 in {-1 pad, 0 bg, 1..C-1 fg class}
    bbox_targets: torch.Tensor  # (R, 4) normalized deltas to the matched gt
    bbox_weight: torch.Tensor  # (R,) 1.0 for fg
    seg_masks: torch.Tensor  # (R, S, S) each sample's OWN segment mask (an input)


def cfm_targets(seg_boxes: torch.Tensor, seg_masks: torch.Tensor, seg_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                gt_masks: torch.Tensor, draws, roi_batch: int = 128,
                fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.0,
                bbox_means=(0.0, 0.0, 0.0, 0.0), bbox_stds=(0.1, 0.1, 0.2, 0.2),
                iou_mode: str = "box") -> CfmTargets:
    """The CFM training sample: :func:`proposal_targets`' rules over a pool
    of PRECOMPUTED segment proposals (K boxes, each with its (S, S) mask in
    its box frame) instead of RPN proposals.

    The gt instances join the pool, each with its own mask resampled into
    its box frame at S; when the pool (K + G) is smaller than ``roi_batch``
    it is padded with invalid zero boxes and masks.  fg: IoU >= fg_thresh,
    labelled with the matched gt's class; bg: IoU in [bg_thresh_lo,
    bg_thresh_hi); a fixed fg quota, then bg fill; normalized box deltas.
    IoU is box IoU, or mask IoU with ``iou_mode="mask"``.  There are no mask
    targets: the segment's own mask rides along as the mask-pooling input.
    ``draws`` is the pair of (pool size,) uniform tensors that rank the fg
    and the bg candidates (see :func:`cfm_pool_size`).
    """
    r_fg, r_bg = draws
    s = seg_masks.shape[-1]
    gt_self_masks = intersect_mask(gt_boxes, gt_boxes, gt_masks, s)
    all_rois = torch.cat([seg_boxes, gt_boxes], dim=0)
    all_masks = torch.cat([seg_masks.float(), gt_self_masks], dim=0)
    all_valid = torch.cat([seg_valid, gt_valid], dim=0)
    if all_rois.shape[0] < roi_batch:  # a small pool (the default K + MAX_GT): pad it
        pad = roi_batch - all_rois.shape[0]
        all_rois = torch.cat([all_rois, all_rois.new_zeros(pad, 4)], dim=0)
        all_masks = torch.cat([all_masks, all_masks.new_zeros(pad, s, s)], dim=0)
        all_valid = torch.cat([all_valid, all_valid.new_zeros(pad)], dim=0)

    if iou_mode == "mask":
        max_ov, arg, mboxes, mcls, fg = _assign_mask_iou(
            all_rois, all_masks, gt_boxes, gt_classes, gt_valid, gt_masks, fg_thresh)
    else:
        max_ov, arg, mboxes, mcls, fg = _assign(all_rois, gt_boxes, gt_classes, gt_valid,
                                                fg_thresh)
    fg = fg & all_valid
    bg = all_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo) & ~fg

    fg_quota = int(round(roi_batch * fg_fraction))
    fg_keep = _random_keep(r_fg, fg, fg_quota, fg_quota)
    bg_keep = _random_keep(r_bg, bg, roi_batch - fg_keep.sum(), roi_batch)

    # fg, then bg, then the rest, each in index order
    sel_key = fg_keep.to(torch.int8) * 2 + bg_keep.to(torch.int8)
    idx = torch.sort(sel_key, descending=True, stable=True).indices[:roi_batch]
    picked_fg = fg_keep[idx]
    picked_bg = bg_keep[idx]

    s_rois = all_rois[idx]
    labels = torch.where(picked_fg, mcls[idx].to(torch.int32),
                         torch.where(picked_bg, 0, -1).to(torch.int32))
    deltas = _normalized_deltas(s_rois, mboxes[idx], bbox_means, bbox_stds)
    bbox_targets = torch.where(picked_fg[:, None], deltas, s_rois.new_zeros(()))
    return CfmTargets(s_rois, labels, bbox_targets, picked_fg.to(torch.float32),
                      all_masks[idx])


def cfm_pool_size(n_segments: int, n_gt: int, roi_batch: int) -> int:
    """Length of each of :func:`cfm_targets`' two draw tensors."""
    return max(n_segments + n_gt, roi_batch)
