"""Batched inference: canvases → per-instance (box, class, score, mask) — port
of the canvas-space half of ``mnc_tpu/pipeline/inference.py``.

Per-class NMS, mask voting (``lib/nms/mv.pyx``), the cross-class top-K and
the full-canvas paste-back, batched over images so each kernel launches once
per batch: per-class NMS runs B × (C−1) problems in one launch of kernel B,
and the paste runs every detection of the batch in one launch of kernel C.
The host API of the JAX package (``detect``/``detect_many`` with ``cv2``
resizing, canvas buckets, ``host_paste``, bit-packed transfer) is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.models.mnc import MNC, MNCArch, _take
from mnc_tpu_torch.ops.mask_voting import box_voting_per_det, mask_voting_per_det
from mnc_tpu_torch.ops.masks import paste_masks
from mnc_tpu_torch.ops.nms import nms_indices


@dataclasses.dataclass(frozen=True)
class PostCfg:
    """Post-processing configuration (reference TEST.* semantics).

    The JAX package's ``vote_impl``, ``paste_impl`` and ``paste_dtype``
    choose between XLA formulations; the port votes with the per-pair hat
    products and pastes in f32 (kernel C on the GPU), so it has no such
    fields."""

    nms_thresh: float = 0.3  # TEST.NMS per-class box NMS
    dets_per_class: int = 16  # padded per-class keep
    max_per_image: int = 100  # TEST.MAX_PER_IMAGE cross-class cap
    use_mask_merge: bool = True  # TEST.USE_MASK_MERGE
    mask_merge_iou: float = 0.5  # TEST.MASK_MERGE_IOU_THRESH
    # voting candidate pool per class: the top vote_top_k by score
    vote_top_k: int = 64
    # TEST.VOTE_BOXES: also average the detection box over the same weighted
    # neighbor set; the merged mask is then voted into the averaged box
    vote_boxes: bool = False
    # TEST.VOTE_BOTH_PASSES (5-stage): pool the first-pass detections too
    vote_both_passes: bool = False
    score_thresh: float = 0.0  # candidates below are dropped
    paste: bool = True  # paste the masks into full canvases
    binarize_thresh: float = 0.4  # cfg.BINARIZE_THRESH

    @classmethod
    def from_cfg(cls, **over) -> "PostCfg":
        # the reference tester NMS'd with MASK_MERGE_NMS_THRESH when voting was
        # on and TEST.NMS otherwise (both 0.3 by default)
        kw = dict(
            nms_thresh=(cfg.TEST.MASK_MERGE_NMS_THRESH
                        if cfg.TEST.USE_MASK_MERGE else cfg.TEST.NMS),
            max_per_image=cfg.TEST.MAX_PER_IMAGE,
            use_mask_merge=bool(cfg.TEST.USE_MASK_MERGE),
            mask_merge_iou=cfg.TEST.MASK_MERGE_IOU_THRESH,
            vote_boxes=bool(cfg.TEST.VOTE_BOXES),
            vote_both_passes=bool(cfg.TEST.VOTE_BOTH_PASSES),
            binarize_thresh=cfg.BINARIZE_THRESH,
        )
        kw.update(over)
        return cls(**kw)


def postprocess_detections(rois: torch.Tensor, roi_valid: torch.Tensor,
                           cls_prob: torch.Tensor, mask_logits: torch.Tensor,
                           post: PostCfg, canvas_hw: tuple[int, int] | None) -> dict:
    """Fixed-shape detection post-processing of a batch.

    Inputs (B, N, 4), (B, N), (B, N, C), (B, N, M, M).  Per foreground class:
    NMS over (rois, class score) → top dets_per_class; then a cross-class top
    max_per_image cut; mask voting merges candidate soft masks into each
    survivor; the masks are pasted into bool canvases.  Returns padded
    (B, K, ...) arrays + ``valid``.  Every top-K is a stable sort, so ties
    keep the lower index first, as ``lax.top_k``.
    """
    b, n, c = cls_prob.shape
    soft_masks = torch.sigmoid(mask_logits)
    d = min(post.dets_per_class, n)

    fg_scores = cls_prob[..., 1:].transpose(1, 2)  # (B, C-1, N)
    ok = roi_valid.unsqueeze(1) & (fg_scores > post.score_thresh)
    idx_c, keep_c = nms_indices(rois.unsqueeze(1).expand(b, c - 1, n, 4), fg_scores,
                                ok, post.nms_thresh, d)  # (B, C-1, d)
    scores_c = torch.where(keep_c, torch.gather(fg_scores, -1, idx_c),
                           torch.zeros((), device=rois.device))
    flat_idx = idx_c.reshape(b, -1)
    flat_scores = scores_c.reshape(b, -1)
    flat_valid = keep_c.reshape(b, -1)
    flat_cls = torch.arange(1, c, device=rois.device).repeat_interleave(d)

    k = min(post.max_per_image, (c - 1) * d)
    key = torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0))
    top = torch.sort(key, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :k], top.indices[:, :k]
    roi_idx = torch.gather(flat_idx, 1, top_idx)  # original roi of each detection
    det_boxes = _take(rois, roi_idx)
    det_classes = flat_cls[top_idx]

    if post.use_mask_merge:
        # vote only the K survivors, each against the top vote_top_k
        # candidates of ITS class (score-weighted IoU neighbors)
        kv = min(post.vote_top_k, n)
        cand = torch.gather(cls_prob.transpose(1, 2), 1,
                            det_classes.unsqueeze(-1).expand(b, k, n))  # (B, K, N)
        cand = torch.where(roi_valid.unsqueeze(1), cand, torch.zeros((), device=cand.device))
        cs_sort = torch.sort(cand, dim=-1, descending=True, stable=True)
        cs, ci = cs_sort.values[..., :kv], cs_sort.indices[..., :kv]  # (B, K, kv)
        cand_boxes = _take(rois, ci).reshape(b * k, kv, 4)
        cs = cs.reshape(b * k, kv)
        flat_boxes = det_boxes.reshape(b * k, 4)
        if post.vote_boxes:
            flat_boxes = box_voting_per_det(flat_boxes, cand_boxes, cs, post.mask_merge_iou)
            det_boxes = flat_boxes.reshape(b, k, 4)
        cand_masks = _take(soft_masks, ci).reshape(b * k, kv, *soft_masks.shape[-2:])
        det_masks = mask_voting_per_det(flat_boxes, cand_boxes, cs, cand_masks,
                                        post.mask_merge_iou)
        det_masks = det_masks.reshape(b, k, *soft_masks.shape[-2:])
    else:
        det_masks = _take(soft_masks, roi_idx)

    out = {
        "boxes": det_boxes,
        "scores": top_scores,
        "classes": det_classes,
        "masks": det_masks,
        "valid": top_scores > 0.0,
    }
    if post.paste and canvas_hw is not None:
        out["canvas_masks"] = paste_masks(det_masks, det_boxes, canvas_hw,
                                          post.binarize_thresh)
    return out


def vote_candidates(net_out: dict, post: PostCfg, n_stages: int, axis: int = 0):
    """(rois, valid, prob, masks) for postprocess — optionally pooling the
    5-stage first-pass detections too (PostCfg.vote_both_passes)."""
    keys = ("rois", "roi_valid", "cls_prob", "mask_logits")
    r, v, c, m = (net_out[k] for k in keys)
    if post.vote_both_passes and n_stages == 5:
        r = torch.cat([r, net_out["stage3_rois"]], axis)
        v = torch.cat([v, net_out["roi_valid"]], axis)
        c = torch.cat([c, net_out["stage3_cls_prob"]], axis)
        m = torch.cat([m, net_out["stage3_mask_logits"]], axis)
    return r, v, c, m


class MNCPipeline:
    """Canvas-space serving front-end: the network and the post-processing
    as one call on the model's device.

        model = MNC(MNCArch.from_cfg())          # cuda; device="cpu" to ask
        model.load_state_dict(state_dict_from_jax(params))
        pipe = MNCPipeline(model)
        dets = pipe.detect_canvas_batch(canvases, im_infos)

    Canvases are (B, H, W, 3) uint8 (mean-subtracted on the device) or
    mean-subtracted float, at the model's canvas size; im_infos (B, 3) =
    (scaled h, scaled w, scale).  Numpy inputs are moved to the device.
    """

    def __init__(self, model: MNC, post: PostCfg | None = None):
        self.model = model
        self.arch: MNCArch = model.arch
        self.post = post or PostCfg.from_cfg()

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def detect_canvas_batch(self, canvases, im_infos) -> dict:
        """Batched throughput path: (B, H, W, 3) + (B, 3) → batched dets."""
        canvases = torch.as_tensor(canvases, device=self.device)
        im_infos = torch.as_tensor(im_infos, dtype=torch.float32, device=self.device)
        net_out = self.model.apply_batch(canvases, im_infos)
        r, v, c, m = vote_candidates(net_out, self.post, self.arch.n_stages, axis=1)
        return postprocess_detections(r, v, c, m, self.post, self.arch.canvas)

    def detect_canvas(self, canvas, im_info) -> dict:
        """One (H, W, 3) canvas + (3,) im_info → dets without the batch dim."""
        out = self.detect_canvas_batch(torch.as_tensor(canvas)[None],
                                       torch.as_tensor(im_info)[None])
        return {k: v[0] for k, v in out.items()}
