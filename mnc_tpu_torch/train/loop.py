"""Training loop: the stage-wise multi-task loss and the train step — port of
``mnc_tpu/train/loop.py``.

≙ the reference ``lib/caffeWrapper/SolverWrapper.py`` + the training
prototxt graph: one optimizer step runs trunk → RPN (+losses) → proposals →
RoI sampling (+targets) → mask loss → classify losses → [5-stage: bridge →
re-targets → mask/classify losses again, shared weights] → SGD, all on the
device.

Gradients flow through RoI warping into the box coordinates and hence into
``rpn_bbox_pred`` / stage-3 ``bbox_pred`` (the MNC end-to-end trick): RoIs
come out of the differentiable ``bbox_transform_inv`` and are gathered by
NMS indices, which select and carry no gradient themselves.

The JAX package vmaps a one-image loss over the batch and averages.  Here
the trunk and the heads run once on the whole batch; target assignment and
the loss reductions loop over the images, so each image keeps its own
random draws and its own normalizers, and every metric is the mean over the
images.  All randomness (subsampling ranks, dropout keep-masks) enters as a
:class:`StepDraws` argument, made by :func:`draw_step_randoms` from a
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from mnc_tpu_torch.models.mnc import MNC, MNCArch, propose_rois, stage_bridge
from mnc_tpu_torch.ops.losses import (
    sigmoid_cross_entropy,
    smooth_l1_loss,
    softmax_cross_entropy,
)
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.train.optim import CaffeSGD

_ONES4 = (1.0, 1.0, 1.0, 1.0)


class StepDraws(NamedTuple):
    """The random numbers of one step, with a leading image axis B."""

    anchor: tuple  # 2 × (B, K) uniforms: ranks of positive / negative anchors
    roi: tuple  # 2 × (B, pool) uniforms: ranks of fg / bg RoIs
    drop1: tuple  # 2 × (B, R, fc_dim) bool keep-masks after fc6 / fc7, pass 1
    drop2: tuple  # the same for the second pass (5-stage)


def draw_step_randoms(gen: torch.Generator, arch: MNCArch, train_cfg: dict, n_images: int,
                      max_gt: int, device=None, keep_prob: float = 0.5) -> StepDraws:
    """All of a step's random numbers from ``gen`` (whose device is the
    default for ``device``)."""
    device = gen.device if device is None else device
    k = arch.feat_hw[0] * arch.feat_hw[1] * arch.num_anchors
    r = train_cfg["BATCH_SIZE"]
    pool = T.proposal_pool_size(arch.post_nms_top_n, max_gt, r)

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def keep():
        return uni(n_images, r, arch.fc_dim) < keep_prob

    return StepDraws((uni(n_images, k), uni(n_images, k)),
                     (uni(n_images, pool), uni(n_images, pool)),
                     (keep(), keep()), (keep(), keep()))


class CfmDraws(NamedTuple):
    """The random numbers of one CFM step (``models/cfm.py``), with a
    leading image axis B."""

    roi: tuple  # 2 × (B, pool) uniforms: ranks of fg / bg segments
    drop: tuple | None  # 2 × (B, R, fc_dim) bool keep-masks after fc6 / fc7; None for
    # the conv5 head (``arch.roi_conv5``), which has no dropout


def draw_cfm_randoms(gen: torch.Generator, arch: MNCArch, train_cfg: dict, n_images: int,
                     n_segments: int, max_gt: int, device=None,
                     keep_prob: float = 0.5) -> CfmDraws:
    """All of a CFM step's random numbers from ``gen`` (whose device is the
    default for ``device``).  The per-RoI conv5 head (``arch.roi_conv5``)
    has no dropout, so none is drawn for it: the JAX package's ``cfm_loss``
    hands it a dropout key that no module uses."""
    device = gen.device if device is None else device
    r = train_cfg["BATCH_SIZE"]
    pool = T.cfm_pool_size(n_segments, max_gt, r)

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device)

    roi = (uni(n_images, pool), uni(n_images, pool))
    if arch.roi_conv5:
        return CfmDraws(roi, None)
    return CfmDraws(roi, tuple(uni(n_images, r, arch.fc_dim) < keep_prob for _ in range(2)))


@dataclasses.dataclass
class TrainState:
    """What a step advances: the model's parameters and the solver's state
    are updated in place; ``step`` counts the calls."""

    step: int
    model: MNC
    opt: CaffeSGD

    @classmethod
    def create(cls, model: MNC, opt: CaffeSGD) -> "TrainState":
        return cls(0, model, opt)


def _stack(tgts: list) -> T.RoiTargets:
    return T.RoiTargets(*(torch.stack(f) for f in zip(*tgts)))


def _roi_losses(model: MNC, feat: torch.Tensor, tgt: T.RoiTargets, keep_masks, arch: MNCArch,
                prefix: str, bbox_inside_weights=_ONES4, bbox_reg: bool = True):
    """Mask + classify losses for one cascade pass over the sampled RoIs of
    the batch: tgt fields carry (B, R, ...).  Returns ({name: (B,) per-image
    losses}, (cls_logits, bbox_pred, mask_logits) with (B, R, ...))."""
    b, r = tgt.labels.shape
    roi_feat = model.warp(feat, tgt.rois)  # (B, R, PH, PW, C)
    flat = roi_feat.reshape(b * r, *roi_feat.shape[2:])
    mask_logits = model.mask_stage(flat)
    keep = tuple(k.reshape(b * r, -1) for k in keep_masks) if keep_masks is not None else None
    cls_logits, bbox_pred = model.classify_stage(flat, mask_logits, True, keep)
    mask_logits = mask_logits.reshape(b, r, *mask_logits.shape[1:])
    cls_logits = cls_logits.reshape(b, r, -1)
    bbox_pred = bbox_pred.reshape(b, r, -1)
    mask_l = torch.stack([sigmoid_cross_entropy(mask_logits[i], tgt.mask_targets[i],
                                                tgt.mask_weight[i][:, None, None])
                          for i in range(b)])
    cls_l, bbox_l = cls_bbox_losses(cls_logits, bbox_pred, tgt.labels, tgt.bbox_targets,
                                    tgt.bbox_weight, arch, bbox_inside_weights, bbox_reg)
    losses = {f"{prefix}_mask": mask_l, f"{prefix}_cls": cls_l, f"{prefix}_bbox": bbox_l}
    return losses, (cls_logits, bbox_pred, mask_logits)


def cls_bbox_losses(cls_logits: torch.Tensor, bbox_pred: torch.Tensor, labels: torch.Tensor,
                    bbox_targets: torch.Tensor, bbox_weight: torch.Tensor, arch: MNCArch,
                    bbox_inside_weights=_ONES4, bbox_reg: bool = True):
    """The classify head's losses over sampled RoIs with (B, R, ...) fields:
    softmax cross entropy (ignore -1) and the SmoothL1 of the label's
    4-vector out of (R, 4C), weighted by ``bbox_weight`` and normalized by
    the image's count of non-ignored RoIs.  Returns two (B,) per-image
    losses; with ``bbox_reg`` off (``TRAIN.BBOX_REG``) the second is 0."""
    b, r = labels.shape
    per_cls = bbox_pred.reshape(b, r, arch.num_classes, 4)
    lbl = labels.clamp_min(0).long()
    sel = torch.gather(per_cls, 2, lbl[..., None, None].expand(b, r, 1, 4)).squeeze(2)
    inside = sel.new_tensor(bbox_inside_weights)
    cls_l, bbox_l = [], []
    for i in range(b):
        cls_l.append(softmax_cross_entropy(cls_logits[i], labels[i], ignore_label=-1))
        if bbox_reg:
            n_valid = torch.maximum((labels[i] >= 0).float().sum(), sel.new_ones(()))
            w = bbox_weight[i][:, None]
            bbox_l.append(smooth_l1_loss(sel[i], bbox_targets[i], inside_weights=w * inside,
                                         outside_weights=(w / n_valid).expand(r, 4)))
        else:
            bbox_l.append(sel.new_zeros(()))
    return torch.stack(cls_l), torch.stack(bbox_l)


def mnc_loss(model: MNC, batch: dict, draws: StepDraws, arch: MNCArch,
             anchors: torch.Tensor, train_cfg: dict, mark=None):
    """Full multi-task loss of a batch of images.

    batch: image (B, H, W, 3), im_info (B, 3), gt_boxes (B, G, 4),
    gt_classes (B, G), gt_valid (B, G), gt_masks (B, G, S, S) (or one image
    without the B axis, with ``draws`` still carrying B = 1).  Returns
    (total, losses): every entry the mean over the images, ``total`` their
    sum, as the JAX package's vmapped ``mnc_loss``.  ``mark``, when given, is
    called with a stage's name as the stage ends (a profiler's hook).
    """
    mark = mark or (lambda name: None)
    if batch["image"].dim() == 3:
        batch = {k: v[None] for k, v in batch.items()}
    im_info = batch["im_info"].float()
    b = im_info.shape[0]
    gt = [(batch["gt_boxes"][i], batch["gt_classes"][i], batch["gt_valid"][i],
           batch["gt_masks"][i]) for i in range(b)]

    # uint8 canvases are mean-subtracted on the device inside MNC.features
    feat = model.features(batch["image"])
    rpn_cls, rpn_bbox = model.rpn(feat)
    mark("trunk + rpn head")

    # ---- stage 1: RPN losses (AnchorTargetLayer semantics)
    rpn_cls_l, rpn_bbox_l = [], []
    for i, (gt_boxes, _, gt_valid, _) in enumerate(gt):
        at = T.anchor_targets(
            anchors, gt_boxes, gt_valid, (im_info[i, 0], im_info[i, 1]),
            (draws.anchor[0][i], draws.anchor[1][i]),
            pos_overlap=train_cfg["RPN_POSITIVE_OVERLAP"],
            neg_overlap=train_cfg["RPN_NEGATIVE_OVERLAP"],
            batch_size=train_cfg["RPN_BATCHSIZE"],
            fg_fraction=train_cfg["RPN_FG_FRACTION"],
            clobber_positives=train_cfg.get("RPN_CLOBBER_POSITIVES", False),
            positive_weight=train_cfg.get("RPN_POSITIVE_WEIGHT", -1.0),
            inside_weights=train_cfg.get("RPN_BBOX_INSIDE_WEIGHTS", _ONES4))
        rpn_cls_l.append(softmax_cross_entropy(rpn_cls[i].reshape(-1, 2), at.labels, -1))
        rpn_bbox_l.append(smooth_l1_loss(rpn_bbox[i].reshape(-1, 4), at.bbox_targets,
                                         at.bbox_inside_w, at.bbox_outside_w, sigma=3.0))

    mark("anchor targets + rpn losses")

    # ---- proposals (differentiable w.r.t. rpn_bbox) + RoI sampling
    rois, roi_valid, _ = propose_rois(rpn_cls, rpn_bbox, im_info, anchors, arch)
    mark("proposals")
    tkw = dict(fg_thresh=train_cfg["FG_THRESH"], mask_size=arch.mask_size,
               bbox_means=arch.bbox_means, bbox_stds=arch.bbox_stds)
    tgt = _stack([T.proposal_targets(
        rois[i], roi_valid[i], *gt[i], (draws.roi[0][i], draws.roi[1][i]),
        roi_batch=train_cfg["BATCH_SIZE"], fg_fraction=train_cfg["FG_FRACTION"],
        bg_thresh_hi=train_cfg["BG_THRESH_HI"], bg_thresh_lo=train_cfg["BG_THRESH_LO"],
        **tkw) for i in range(b)])
    mark("proposal targets")

    # ---- stages 2-3
    biw = train_cfg.get("BBOX_INSIDE_WEIGHTS", _ONES4)
    breg = train_cfg.get("BBOX_REG", True)
    losses, (cls_logits, bbox_pred, _) = _roi_losses(
        model, feat, tgt, draws.drop1, arch, "s23", bbox_inside_weights=biw, bbox_reg=breg)
    mark("heads pass 1 + losses")

    if arch.n_stages == 5:
        # ---- bridge + stages 4-5 (shared weights).  Training regresses
        # NORMALIZED targets by construction, so the bridge always
        # de-normalizes here, whatever arch.bbox_pred_normalized says
        cls_prob = torch.softmax(cls_logits, dim=-1)
        rois2 = stage_bridge(tgt.rois, cls_prob, bbox_pred, im_info, arch,
                             bbox_pred_normalized=True)
        tgt2 = _stack([T.reassign_targets(rois2[i], tgt.labels[i], *gt[i], **tkw)
                       for i in range(b)])
        mark("bridge + re-targets")
        losses45, _ = _roi_losses(model, feat, tgt2, draws.drop2, arch, "s45",
                                  bbox_inside_weights=biw, bbox_reg=breg)
        losses.update(losses45)
        mark("heads pass 2 + losses")

    losses["rpn_cls"] = torch.stack(rpn_cls_l)
    losses["rpn_bbox"] = torch.stack(rpn_bbox_l)
    losses = {k: v.mean() for k, v in losses.items()}
    total = sum(losses.values())
    losses["total"] = total
    return total, losses


def train_cfg_from_cfg(cfg) -> dict:
    """The TRAIN.* keys that :func:`mnc_loss` reads, from the global cfg."""
    t = cfg.TRAIN
    return dict(
        RPN_POSITIVE_OVERLAP=t.RPN_POSITIVE_OVERLAP, RPN_NEGATIVE_OVERLAP=t.RPN_NEGATIVE_OVERLAP,
        RPN_BATCHSIZE=t.RPN_BATCHSIZE, RPN_FG_FRACTION=t.RPN_FG_FRACTION,
        BATCH_SIZE=t.BATCH_SIZE, FG_FRACTION=t.FG_FRACTION, FG_THRESH=t.FG_THRESH,
        BG_THRESH_HI=t.BG_THRESH_HI, BG_THRESH_LO=t.BG_THRESH_LO, BBOX_REG=t.BBOX_REG,
        RPN_CLOBBER_POSITIVES=t.RPN_CLOBBER_POSITIVES,
        RPN_POSITIVE_WEIGHT=t.RPN_POSITIVE_WEIGHT,
        RPN_BBOX_INSIDE_WEIGHTS=tuple(t.RPN_BBOX_INSIDE_WEIGHTS),
        BBOX_INSIDE_WEIGHTS=tuple(t.BBOX_INSIDE_WEIGHTS))


@contextlib.contextmanager
def deterministic_cudnn():
    """Holds cuDNN to deterministic algorithms for a training forward and
    backward: inside, ``torch.backends.cudnn.deterministic`` is True and
    ``benchmark`` False; on leaving, both are back to what they were, and
    no other flag is touched (``cudnn.flags(...)`` would reset ``enabled``
    and ``allow_tf32`` to its own defaults).

    With it, a train step on the card is a pure function of (state, batch,
    draws), as the JAX package's is: cuDNN's nondeterministic backward
    algorithms sum a weight's gradient in a run-dependent order, and
    ``benchmark`` may pick another algorithm from one process to the next.
    Every train step of the port enters it; on the CPU it changes
    nothing."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def build_train_step(model: MNC, opt: CaffeSGD, arch: MNCArch, train_cfg: dict):
    """The train step: (state, batch, draws) → (state, metrics).

    ``batch`` holds tensors on the model's device, one image or a batch (see
    :func:`mnc_loss`); ``draws`` is a :class:`StepDraws`, or a
    ``torch.Generator`` to draw them from.  ``metrics`` are 0-dim tensors on
    the device (no host synchronisation happens here).  The model and the
    solver are updated in place, under :func:`deterministic_cudnn`: two
    steps from one state, batch and draws give the same bits.
    """
    anchors = model.anchors

    def step(state: TrainState, batch: dict, draws):
        if isinstance(draws, torch.Generator):
            single = batch["image"].dim() == 3
            draws = draw_step_randoms(draws, arch, train_cfg,
                                      1 if single else batch["image"].shape[0],
                                      batch["gt_boxes"].shape[-2], model.device)
        with deterministic_cudnn():
            total, metrics = mnc_loss(model, batch, draws, arch, anchors, train_cfg)
            total.backward()
            opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


# PyTorch runs eagerly: there is no jitted form to tell apart
make_train_step = build_train_step
