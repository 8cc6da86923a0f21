"""CFM — Convolutional Feature Masking, the reference's second model family
— port of ``mnc_tpu/models/cfm.py``.

Instead of RPN proposals and a learned mask head, the classify head runs
over PRE-COMPUTED segment proposals (MCG, ``tools/prepare_mcg_maskdb.py``):
each segment's box is RoI-warped from the shared trunk features (kernel A)
and mask-pooled with the segment's OWN mask, resized to the warp grid, then
classified by the fc head.  There is no RPN and no mask regression.  It
reuses the MNC module's trunk and classify head, so a trained MNC
checkpoint evaluates in CFM mode directly.

Test mode (:func:`cfm_detect`) runs one image through :func:`cfm_apply` and
the MNC post-processing (per-class NMS, kernel B; mask voting; the canvas
paste, kernel C).  Training (:func:`cfm_loss`, :func:`make_cfm_train_step`)
samples the segment pool per image (``train.targets.cfm_targets``) and
trains the trunk and the classify head: the RPN and the mask head get no
gradient, and the solver treats that as zeros (weight decay still moves
their kernels, as in the JAX package).  Randomness enters as a
``train.loop.CfmDraws`` argument.
"""

from __future__ import annotations

import functools

import torch

from mnc_tpu_torch.models.mnc import MNC, MNCArch, linear_resize_matrix, stage_bridge
from mnc_tpu_torch.pipeline.inference import PostCfg, postprocess_detections
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.train.loop import (CfmDraws, TrainState, cls_bbox_losses, deterministic_cudnn,
                                      draw_cfm_randoms)
from mnc_tpu_torch.train.optim import CaffeSGD


def _clipped_logits(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-4, 1.0 - 1e-4)
    return torch.log(p) - torch.log1p(-p)


@functools.lru_cache(maxsize=16)
def _resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``linear_resize_matrix`` on ``device``, copied there once."""
    return torch.from_numpy(linear_resize_matrix(in_size, out_size)).to(device)


def mask_pseudo_logits(masks: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, S, S) binary or soft segment masks → (N, out, out) f32 logits.

    ``MNC.classify_stage`` takes the sigmoid of mask logits and resizes them
    to the warp grid itself, so a GIVEN mask enters as the clipped logits of
    its resize to ``out_size``: ``jax.image.resize(..., "linear")``, which
    antialiases when it shrinks (``linear_resize_matrix``), then clip and
    ``log(p) - log1p(-p)`` in f32."""
    r = _resize_matrix(masks.shape[-1], out_size, masks.device)
    return _clipped_logits(r @ masks.float() @ r.T)


@torch.inference_mode()
def cfm_apply(model: MNC, image: torch.Tensor, im_info: torch.Tensor, seg_boxes: torch.Tensor,
              seg_masks: torch.Tensor, seg_valid: torch.Tensor,
              refine_boxes: bool = True) -> dict:
    """Classify the precomputed segments of one image.

    image (H, W, 3) canvas (uint8, or mean-subtracted float), im_info (3,) =
    (h, w, scale), seg_boxes (N, 4) canvas-coordinate boxes (padded),
    seg_masks (N, S, S) masks in their box frames, seg_valid (N,).  With
    ``refine_boxes`` the boxes take the class-specific regression (the
    stage bridge).  Returns cls_prob (N, C), boxes (N, 4), masks (the input
    masks) and valid (N,)."""
    arch = model.arch
    feat = model.features(image[None])
    roi_feat = model.warp(feat, seg_boxes.float()[None])[0]  # (N, 14, 14, C)
    cls_logits, bbox_pred = model.classify_stage(
        roi_feat, mask_pseudo_logits(seg_masks, arch.mask_size))
    cls_prob = torch.softmax(cls_logits, dim=-1)
    boxes = seg_boxes
    if refine_boxes:
        boxes = stage_bridge(seg_boxes, cls_prob, bbox_pred, im_info.float(), arch)
    return {"cls_prob": cls_prob, "boxes": boxes, "masks": seg_masks, "valid": seg_valid}


@torch.inference_mode()
def cfm_detect(model: MNC, image, im_info, seg_boxes, seg_masks, seg_valid, post: PostCfg,
               refine_boxes: bool = True) -> dict:
    """CFM test-mode inference of one image: :func:`cfm_apply` scores every
    segment, then ``postprocess_detections`` (per-class NMS, mask voting of
    the segments' own masks, canvas paste) gives the detections.  Inputs as
    :func:`cfm_apply` (numpy arrays are moved to the model's device);
    returns the padded (K, ...) detection arrays of ``postprocess_detections``
    without a batch axis."""
    dev = model.device
    image, im_info, seg_boxes, seg_masks, seg_valid = (
        torch.as_tensor(x, device=dev) for x in (image, im_info, seg_boxes, seg_masks,
                                                  seg_valid))
    out = cfm_apply(model, image, im_info, seg_boxes, seg_masks, seg_valid,
                    refine_boxes=refine_boxes)
    dets = postprocess_detections(out["boxes"][None], out["valid"][None],
                                  out["cls_prob"][None],
                                  _clipped_logits(out["masks"].float())[None], post,
                                  model.arch.canvas)
    return {k: v[0] for k, v in dets.items()}


def cfm_loss(model: MNC, batch: dict, draws: CfmDraws, arch: MNCArch, train_cfg: dict):
    """CFM training loss of a batch of images.

    trunk → sample each image's segment pool (``cfm_targets``) → RoI-warp the
    sampled segments → mask-pool each with its own mask → classify; softmax
    cross entropy (ignore -1) + per-class SmoothL1 box regression on fg.

    batch: image (B, H, W, 3), im_info (B, 3), seg_boxes (B, K, 4),
    seg_masks (B, K, S, S), seg_valid (B, K), gt_boxes (B, G, 4), gt_classes
    (B, G), gt_valid (B, G), gt_masks (B, G, S', S') (or one image without
    the B axis, with ``draws`` still carrying B = 1).  Returns (total,
    losses): each loss the mean over the images and ``total`` their sum, as
    the JAX package's vmapped ``cfm_loss`` and mean.
    """
    if batch["image"].dim() == 3:
        batch = {k: v[None] for k, v in batch.items()}
    b = batch["image"].shape[0]
    r = train_cfg["BATCH_SIZE"]
    feat = model.features(batch["image"])
    tgts = [T.cfm_targets(
        batch["seg_boxes"][i], batch["seg_masks"][i], batch["seg_valid"][i],
        batch["gt_boxes"][i], batch["gt_classes"][i], batch["gt_valid"][i],
        batch["gt_masks"][i], (draws.roi[0][i], draws.roi[1][i]), roi_batch=r,
        fg_fraction=train_cfg["FG_FRACTION"], fg_thresh=train_cfg["FG_THRESH"],
        bg_thresh_hi=train_cfg["BG_THRESH_HI"], bg_thresh_lo=train_cfg["BG_THRESH_LO"],
        bbox_means=arch.bbox_means, bbox_stds=arch.bbox_stds,
        iou_mode=train_cfg.get("CFM_IOU", "box")) for i in range(b)]
    tgt = T.CfmTargets(*(torch.stack(f) for f in zip(*tgts)))

    roi_feat = model.warp(feat, tgt.rois)  # (B, R, PH, PW, C)
    flat = roi_feat.reshape(b * r, *roi_feat.shape[2:])
    pseudo = mask_pseudo_logits(tgt.seg_masks.reshape(b * r, *tgt.seg_masks.shape[2:]),
                                arch.mask_size)
    keep = None if draws.drop is None else tuple(k.reshape(b * r, -1) for k in draws.drop)
    cls_logits, bbox_pred = model.classify_stage(flat, pseudo, True, keep)
    cls_l, bbox_l = cls_bbox_losses(cls_logits.reshape(b, r, -1), bbox_pred.reshape(b, r, -1),
                                    tgt.labels, tgt.bbox_targets, tgt.bbox_weight, arch,
                                    train_cfg.get("BBOX_INSIDE_WEIGHTS", (1.0,) * 4),
                                    train_cfg.get("BBOX_REG", True))
    losses = {"cfm_cls": cls_l.mean(), "cfm_bbox": bbox_l.mean()}
    total = losses["cfm_cls"] + losses["cfm_bbox"]
    losses["total"] = total
    return total, losses


def build_cfm_train_step(model: MNC, opt: CaffeSGD, arch: MNCArch, train_cfg: dict):
    """The CFM train step: (state, batch, draws) → (state, metrics), as
    ``train.loop.build_train_step``: ``batch`` (see :func:`cfm_loss`) holds
    tensors on the model's device; ``draws`` is a ``CfmDraws`` or a
    ``torch.Generator`` to draw them from; the model and the solver are
    updated in place, under ``deterministic_cudnn``; ``metrics`` are 0-dim
    tensors on the device."""

    def step(state: TrainState, batch: dict, draws):
        if isinstance(draws, torch.Generator):
            single = batch["image"].dim() == 3
            draws = draw_cfm_randoms(draws, arch, train_cfg,
                                     1 if single else batch["image"].shape[0],
                                     batch["seg_boxes"].shape[-2],
                                     batch["gt_boxes"].shape[-2], model.device)
        with deterministic_cudnn():
            total, metrics = cfm_loss(model, batch, draws, arch, train_cfg)
            total.backward()
            opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


# PyTorch runs eagerly: there is no jitted form to tell apart
make_cfm_train_step = build_cfm_train_step
