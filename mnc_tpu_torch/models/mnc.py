"""The Multi-task Network Cascade — port of ``mnc_tpu/models/mnc.py``.

Trunk → RPN → proposals (decode, clip, min-size, top-K, NMS, top-N) → RoI
warp → mask head → mask pooling → classify head → stage bridge → the second
pass through the same shared-weight heads.  Everything is fixed-shape, as in
the JAX package: proposals are a padded top-N with a validity mask, so the
outputs compare with the JAX package's element by element.  The JAX
package's ``fault_dodges`` structures (an optimization barrier, ``lax.map``)
work around a TPU fault; their selections are exact, so the port has no
counterpart.  Training uses the stage methods (``features``, ``rpn``,
``warp``, ``mask_stage``, ``classify_stage``) from
``mnc_tpu_torch.train.loop``, so that target sampling can come between them.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import warnings

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mnc_tpu_torch import config as C
from mnc_tpu_torch.models.heads import ClassifyHead, MaskHead, RPNHead
from mnc_tpu_torch.models.resnet import _DEPTHS, ConvRoIHead, FrozenBN, ResNetTrunk
from mnc_tpu_torch.models.vgg import VGG16Trunk
from mnc_tpu_torch.ops.anchors import shifted_anchors
from mnc_tpu_torch.ops.bbox import bbox_transform_inv, clip_boxes, take_rows
from mnc_tpu_torch.ops.nms import nms_indices
from mnc_tpu_torch.ops.quant import QUANT_LAYERS
from mnc_tpu_torch.ops.roi_warp import roi_warp
from mnc_tpu_torch.utils import spans
from mnc_tpu_torch.utils.blob import device_normalize
from mnc_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cap(ref_val: int, static_val: int, ref_key: str, static_key: str) -> int:
    """Reference knob capped by its STATIC budget — loudly."""
    if ref_val > static_val:
        warnings.warn(
            f"{ref_key}={ref_val} is CAPPED by {static_key}={static_val}; the "
            f"working set is {static_val}. Raise {static_key} to actually run "
            f"the requested budget.", stacklevel=3)
    return min(static_val, ref_val)


@dataclasses.dataclass(frozen=True)
class MNCArch:
    """Static architecture/shape configuration of the cascade."""

    canvas: tuple[int, int] = (640, 1024)
    feat_stride: int = 16
    anchor_scales: tuple = (8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    num_classes: int = 21
    mask_size: int = 21
    warp_hw: int = 14
    # fc6 input resolution after the classify head's max pool; None → warp_hw // 2
    pooled_hw: int | None = None
    n_stages: int = 5
    # "vgg16" or "resnet50" / "resnet101" / "resnet152"
    trunk: str = "vgg16"
    compute_dtype: torch.dtype = torch.bfloat16
    fc_dim: int = 4096
    mask_fc_dim: int = 256
    # NET.DUAL_PATHWAY: the fc head also pools the raw RoI features
    dual_pathway: bool = False
    # NET.ROI_CONV5 (ResNet only): the conv5 stage runs per RoI after the
    # warp (ConvRoIHead) in place of the fc6/fc7 tower
    roi_conv5: bool = False
    # NET.RESNET_STRIDE_IN_3X3: False = v1 (stride on the first 1x1, the
    # MSRA geometry), True = v1.5 (torchvision's checkpoints)
    resnet_stride_in_3x3: bool = False
    # proposal shapes
    pre_nms_top_n: int = 1024
    post_nms_top_n: int = 304
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 16.0
    # working sets larger than this stop the NMS scan at post_nms_top_n keeps
    nms_chunk: int = 1024
    # bbox target normalization constants (re-applied by the stage bridge
    # when bbox_pred emits normalized deltas)
    bbox_means: tuple = (0.0, 0.0, 0.0, 0.0)
    bbox_stds: tuple = (0.1, 0.1, 0.2, 0.2)
    bbox_pred_normalized: bool = True
    # TEST.BBOX_REG: when False, the 5-stage bridge keeps the unrefined boxes
    test_bbox_reg: bool = True
    # zero proposals of anchor types that have no fully-inside position on
    # this canvas (off for imported weights: the reference scores all anchors)
    suppress_untrainable_anchors: bool = True
    # trunk blocks with stopped gradients (the reference froze conv1-conv2,
    # which were ImageNet-pretrained; set 0 when training from random init)
    trunk_frozen: int = 2
    # NET.FUSED_BLOCK1: run VGG block 1 as the fused CUDA kernel
    # (ops/block1.py) when compute_dtype is bf16, H % 8 == 0 and W % 2 == 0;
    # same parameters, within 1 bf16 ulp of the unfused layers.  Ignored by
    # the ResNet trunks, as in the JAX package, and under int8_inference
    fused_block1: bool = False
    # TEST.INT8 (inference only): every trunk convolution (and the conv5
    # head's) and fc_mask/fc6/fc7 run s8 x s8 -> s32 (ops/quant.py, kernel E
    # on the card) with the same parameters; the activation scale of a
    # convolution covers all the canvases (RoIs) of a batch
    int8_inference: bool = False
    # rematerialize the trunk in the backward (the JAX package's nn.remat):
    # its activations are dropped after the forward and recomputed when the
    # gradient needs them.  Memory, not math: the same loss and gradients
    remat_trunk: bool = False

    def __post_init__(self):
        if self.pooled_hw is None:
            object.__setattr__(self, "pooled_hw", max(self.warp_hw // 2, 1))
        assert self.warp_hw % self.pooled_hw == 0, (
            f"warp_hw {self.warp_hw} must be a multiple of pooled_hw {self.pooled_hw}")
        # clamp the static NMS working set to the actual anchor count
        fh, fw = self.feat_hw
        total = fh * fw * self.num_anchors
        pre = min(self.pre_nms_top_n, total)
        object.__setattr__(self, "pre_nms_top_n", pre)
        object.__setattr__(self, "post_nms_top_n", min(self.post_nms_top_n, pre))

    @classmethod
    def from_cfg(cls, train: bool = False, **overrides) -> "MNCArch":
        """The architecture of the global cfg, with the TEST.* working set
        and thresholds, or the TRAIN.* ones when ``train``.

        ``TEST.INT8`` sets ``int8_inference`` for the test split only
        (training always runs in the float compute dtype).
        ``NET.S2D_BLOCK1`` only changes the JAX package's layout of block 1
        (no kernel, same math) and is ignored."""
        cfg = C.cfg
        split = cfg.TRAIN if train else cfg.TEST
        name = "TRAIN" if train else "TEST"
        static_pre = getattr(cfg.STATIC, f"{name}_PRE_NMS_TOP_N")
        static_post = getattr(cfg.STATIC, f"{name}_POST_NMS_TOP_N")
        kw = dict(
            canvas=tuple(cfg.STATIC.CANVAS),
            feat_stride=cfg.STATIC.FEAT_STRIDE,
            anchor_scales=tuple(cfg.NET.ANCHOR_SCALES),
            anchor_ratios=tuple(cfg.NET.ANCHOR_RATIOS),
            num_classes=cfg.NET.NUM_CLASSES,
            mask_size=cfg.MASK_SIZE,
            warp_hw=cfg.NET.WARP_HW,
            pooled_hw=cfg.NET.POOLED_HW,
            n_stages=cfg.NET.N_STAGES,
            trunk=cfg.NET.TRUNK,
            compute_dtype=_DTYPES[cfg.NET.COMPUTE_DTYPE],
            fc_dim=cfg.NET.FC_DIM,
            mask_fc_dim=cfg.NET.MASK_FC_DIM,
            dual_pathway=bool(cfg.NET.DUAL_PATHWAY),
            roi_conv5=bool(cfg.NET.ROI_CONV5),
            resnet_stride_in_3x3=bool(cfg.NET.RESNET_STRIDE_IN_3X3),
            suppress_untrainable_anchors=bool(cfg.NET.SUPPRESS_UNTRAINABLE_ANCHORS),
            pre_nms_top_n=_cap(split.RPN_PRE_NMS_TOP_N, static_pre,
                               f"{name}.RPN_PRE_NMS_TOP_N",
                               f"STATIC.{name}_PRE_NMS_TOP_N"),
            # reference knob capped by STATIC, rounded up to a multiple of 8
            post_nms_top_n=_cap(-(-split.RPN_POST_NMS_TOP_N // 8) * 8, static_post,
                                f"{name}.RPN_POST_NMS_TOP_N (8-padded)",
                                f"STATIC.{name}_POST_NMS_TOP_N"),
            rpn_nms_thresh=split.RPN_NMS_THRESH,
            rpn_min_size=float(split.RPN_MIN_SIZE),
            test_bbox_reg=bool(train or cfg.TEST.BBOX_REG),
            bbox_means=(tuple(cfg.TRAIN.BBOX_NORMALIZE_MEANS)
                        if cfg.TRAIN.BBOX_NORMALIZE_TARGETS else (0.0,) * 4),
            bbox_stds=(tuple(cfg.TRAIN.BBOX_NORMALIZE_STDS)
                       if cfg.TRAIN.BBOX_NORMALIZE_TARGETS else (1.0,) * 4),
            nms_chunk=int(cfg.STATIC.NMS_CHUNK) or (512 if train else 256),
            trunk_frozen=int(cfg.NET.TRUNK_FROZEN),
            fused_block1=bool(cfg.NET.FUSED_BLOCK1),
            int8_inference=bool(cfg.TEST.INT8) and not train,
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def feat_hw(self) -> tuple[int, int]:
        return self.canvas[0] // self.feat_stride, self.canvas[1] // self.feat_stride

    @property
    def spatial_scale(self) -> float:
        return 1.0 / self.feat_stride

    def all_anchors(self) -> np.ndarray:
        fh, fw = self.feat_hw
        return shifted_anchors(fh, fw, self.feat_stride, self.anchor_ratios,
                               self.anchor_scales)

    def trainable_anchor_mask(self) -> np.ndarray:
        """(K,) bool — False for anchors whose TYPE has no fully-inside
        position on this canvas (such types are never trained, so their
        test-time scores are noise)."""
        a = self.all_anchors()
        h, w = self.canvas
        na = self.num_anchors
        inside = (a[:, 0] >= 0) & (a[:, 1] >= 0) & (a[:, 2] < w) & (a[:, 3] < h)
        type_trainable = inside.reshape(-1, na).any(axis=0)  # (A,)
        return np.tile(type_trainable, a.shape[0] // na)


@functools.lru_cache(maxsize=16)
def _arch_constants(arch: MNCArch, device: torch.device) -> dict:
    """Per-(arch, device) constant tensors, copied to the device once: a
    copy from host memory in the serving path would stall the host until
    the device caught up, and leave the device idle while the host then
    enqueues the next kernels."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return {"trainable": t(arch.trainable_anchor_mask(), torch.bool),
            "bbox_stds": t(arch.bbox_stds), "bbox_means": t(arch.bbox_means)}


# --------------------------------------------------------------------------- #
# ProposalLayer (≙ lib/pylayer/proposal_layer.py)
# --------------------------------------------------------------------------- #


def propose_rois(rpn_cls: torch.Tensor, rpn_bbox: torch.Tensor, im_info: torch.Tensor,
                 anchors: torch.Tensor, arch: MNCArch):
    """RPN outputs → padded (B, post_nms_top_n, 4) RoIs + validity + scores.

    rpn_cls (B, Hf, Wf, 2A) interleaved (bg, fg) logits per anchor and
    rpn_bbox (B, Hf, Wf, 4A) deltas, both NHWC; im_info (B, 3) = (h, w,
    scale) of the scaled image inside the canvas; anchors (K, 4).  One image
    without the batch dim (im_info (3,)) works too.  The top-K and every
    sort are stable, so equal scores keep the lower anchor index first, as
    ``lax.top_k`` does.
    """
    single = im_info.dim() == 1
    if single:
        rpn_cls, rpn_bbox, im_info = rpn_cls[None], rpn_bbox[None], im_info[None]
    b = rpn_cls.shape[0]
    scores = torch.softmax(rpn_cls.reshape(b, -1, 2), dim=-1)[..., 1]  # (B, K)
    deltas = rpn_bbox.reshape(b, -1, 4)
    assert scores.shape[1] == anchors.shape[0], (scores.shape, anchors.shape)

    boxes = bbox_transform_inv(anchors, deltas)
    boxes = clip_boxes(boxes, (im_info[:, 0:1], im_info[:, 1:2]))

    # min-size filter at input scale (reference: RPN_MIN_SIZE * im_scale)
    min_size = arch.rpn_min_size * im_info[:, 2:3]
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    valid = (ws >= min_size) & (hs >= min_size)
    if arch.suppress_untrainable_anchors:
        valid = valid & _arch_constants(arch, valid.device)["trainable"]

    neg_inf = torch.finfo(torch.float32).min
    masked = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    top = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores = top.values[:, :arch.pre_nms_top_n]
    top_idx = top.indices[:, :arch.pre_nms_top_n]
    top_boxes = take_rows(boxes, top_idx)
    top_valid = top_scores > neg_inf

    # presorted: descending scores with the invalid padding trailing.  NMS
    # only selects (no gradient); the gathers below carry the gradient
    idx, keep_valid = nms_indices(top_boxes.detach(), top_scores.detach(), top_valid,
                                  arch.rpn_nms_thresh,
                                  arch.post_nms_top_n, chunk=arch.nms_chunk,
                                  presorted=True)
    rois = take_rows(top_boxes, idx)
    roi_scores = torch.where(keep_valid, torch.gather(top_scores, 1, idx),
                             torch.zeros((), device=idx.device))
    if single:
        return rois[0], keep_valid[0], roi_scores[0]
    return rois, keep_valid, roi_scores


# --------------------------------------------------------------------------- #
# StageBridge (≙ lib/pylayer/stage_bridge_layer.py)
# --------------------------------------------------------------------------- #


def stage_bridge(rois: torch.Tensor, cls_prob: torch.Tensor, bbox_pred: torch.Tensor,
                 im_info: torch.Tensor, arch: MNCArch,
                 bbox_pred_normalized: bool | None = None) -> torch.Tensor:
    """Refine RoIs with the predicted class's box deltas (5-stage bridge).

    rois (..., N, 4), cls_prob (..., N, C), bbox_pred (..., N, 4C), im_info
    (..., 3).  Picks the first argmax foreground class per RoI (as
    ``jnp.argmax``), de-normalizes its deltas when the params regress
    normalized targets, decodes and clips to the image.
    """
    if bbox_pred_normalized is None:
        bbox_pred_normalized = arch.bbox_pred_normalized
    c = cls_prob.shape[-1]
    fg_cls = cls_prob[..., 1:].argmax(-1) + 1  # (..., N) ∈ [1, C)
    deltas = bbox_pred.reshape(*bbox_pred.shape[:-1], c, 4)
    sel = torch.gather(deltas, -2, fg_cls[..., None, None].expand(
        *fg_cls.shape, 1, 4)).squeeze(-2)
    if bbox_pred_normalized:
        const = _arch_constants(arch, sel.device)
        sel = sel * const["bbox_stds"] + const["bbox_means"]
    refined = bbox_transform_inv(rois, sel)
    return clip_boxes(refined, (im_info[..., 0:1], im_info[..., 1:2]))


# --------------------------------------------------------------------------- #
# The soft-mask resize M → warp_hw
# --------------------------------------------------------------------------- #


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) f32 weights of ``jax.image.resize(..., "linear")`` along one
    axis.  That resize antialiases when it downsamples: the triangle kernel
    is widened by in/out and each output's weights are normalized, which
    ``F.interpolate`` does not do."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)  # (in, out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(np.float32)


# --------------------------------------------------------------------------- #
# The cascade module
# --------------------------------------------------------------------------- #


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    # flax's lecun_normal: truncated normal at ±2σ, rescaled to variance 1/fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class MNC(nn.Module):
    """Full MNC network: trunk + RPN + shared mask/classify heads.

    The trunk is VGG-16 or a ResNet (``arch.trunk``); the classify head is
    the fc6/fc7 tower, or the per-RoI conv5 stage with ``arch.roi_conv5``
    (ResNet only).

    Args:
      arch: the static configuration.
      device: ``None`` (= ``cuda``; raises without a GPU) or an explicit
        device such as ``"cpu"``.
      seed: seeds the random init, which follows the JAX package's flax
        initializers (lecun-normal kernels, zero biases, normal(0.001) for
        ``bbox_pred``, FrozenBN scales of ones and zeros on every ``bn3``).
        Load trained or bridged weights with ``load_state_dict``.  ``None``:
        no init (the layers are built on the meta device and their memory
        left uninitialized on ``device``) for a caller that loads every
        weight next; the init of a full-width model takes seconds of CPU.
      train: ``False`` (serving): the weights are held in
        ``arch.compute_dtype`` and take no gradient; under
        ``arch.int8_inference`` the int8 layers' weights and biases stay f32,
        since they are quantized from the f32 values, as in the JAX package.
        ``True``: the weights are f32 master parameters that take gradients,
        every layer casts them to ``arch.compute_dtype`` in its forward (the
        JAX package's ``param_dtype=float32``), and the module is in
        training mode.
    """

    def __init__(self, arch: MNCArch = MNCArch(), device=None, seed: int | None = 0,
                 train: bool = False):
        super().__init__()
        with spans.setup_span("mnc.build"):
            dev = resolve_device(device)
            self.arch = a = arch
            cd = a.compute_dtype
            with contextlib.nullcontext() if seed is not None else torch.device("meta"):
                self._build_layers(a)
            if seed is None:
                self.to_empty(device=dev)
            else:
                self._init_layers(seed)
            self.register_buffer("anchors", torch.from_numpy(a.all_anchors()),
                                 persistent=False)
            self.register_buffer("resize_mat", torch.from_numpy(
                linear_resize_matrix(a.mask_size, a.warp_hw)), persistent=False)
            self.requires_grad_(train)
            self.train(train)
            self.to(dev)
            if not train:
                for m in (self.trunk, self.rpn_head, self.mask_head, self.classify_head):
                    for mod in m.modules():
                        if not isinstance(mod, QUANT_LAYERS):
                            mod._apply(lambda t: t.to(cd), recurse=False)
            if dev.type == "cuda":  # cuDNN's NHWC kernels for the NHWC convolutions
                for m in (self.trunk, self.rpn_head, self.classify_head):
                    m.to(memory_format=torch.channels_last)

    def _build_layers(self, a: MNCArch) -> None:
        cd = a.compute_dtype
        q = a.int8_inference  # no gradient passes the int8 layers
        if a.trunk == "vgg16":
            self.trunk, c = VGG16Trunk(cd, a.trunk_frozen, a.fused_block1, q), 512
        elif a.trunk in {f"resnet{d}" for d in _DEPTHS}:
            depth = int(a.trunk[len("resnet"):])
            self.trunk = ResNetTrunk(depth, cd, a.trunk_frozen, a.resnet_stride_in_3x3, q)
            c = self.trunk.out_channels
        else:
            raise ValueError(f"unknown trunk {a.trunk!r}")
        self.rpn_head = RPNHead(a.num_anchors, c, compute_dtype=cd)
        self.mask_head = MaskHead(a.warp_hw * a.warp_hw * c, a.mask_fc_dim, a.mask_size, cd,
                                  q)
        if a.roi_conv5:
            if a.trunk == "vgg16":
                raise ValueError("NET.ROI_CONV5 is the ResNet per-RoI conv5 head; "
                                 f"the trunk is {a.trunk!r}")
            self.classify_head = ConvRoIHead(a.num_classes, depth, c, cd,
                                             a.resnet_stride_in_3x3, q)
        else:
            self.classify_head = ClassifyHead(a.pooled_hw * a.pooled_hw * c, a.num_classes,
                                              a.fc_dim, a.warp_hw // a.pooled_hw, cd,
                                              dual_pathway=a.dual_pathway, int8=q)

    def _init_layers(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for mod_name, mod in self.named_modules():
            if isinstance(mod, FrozenBN):
                nn.init.constant_(mod.scale, 0.0 if mod.zero_scale else 1.0)
                nn.init.zeros_(mod.bias)
                continue
            for leaf, p in mod.named_parameters(recurse=False):
                if leaf == "bias":
                    nn.init.zeros_(p)
                elif mod_name == "classify_head.bbox_pred":
                    nn.init.normal_(p, 0.0, 0.001, generator=gen)
                else:
                    _lecun_normal_(p, p[0].numel(), gen)

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def for_canvas(self, canvas_hw: tuple[int, int]) -> "MNC":
        """This model on another canvas (the portrait transpose, a
        ``TEST.CANVAS_BUCKETS`` entry): the same modules and parameter
        tensors, its own ``arch`` and anchors.  The layers do not depend on
        the canvas; only the anchors and the per-arch constants do."""
        arch = dataclasses.replace(self.arch, canvas=tuple(canvas_hw))
        variant = copy.copy(self)  # shares _modules and _parameters
        variant._buffers = dict(self._buffers)
        variant.arch = arch
        variant.anchors = torch.from_numpy(arch.all_anchors()).to(self.device)
        return variant

    # ---- stage pieces ----

    def features(self, images: torch.Tensor) -> torch.Tensor:
        x = device_normalize(images)
        if self.arch.remat_trunk and torch.is_grad_enabled():
            # the trunk's forward runs again in the backward, kernel D's
            # autograd.Function included; no trunk layer draws random numbers
            return checkpoint(self.trunk, x, use_reentrant=False)
        return self.trunk(x)

    def rpn(self, feat: torch.Tensor):
        return self.rpn_head(feat)

    def warp(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        a = self.arch
        return roi_warp(feat, rois, (a.warp_hw, a.warp_hw), a.spatial_scale)

    def mask_stage(self, roi_feat: torch.Tensor) -> torch.Tensor:
        """Warped RoI features (N, 14, 14, C) → mask logits (N, M, M)."""
        return self.mask_head(roi_feat)

    def classify_stage(self, roi_feat: torch.Tensor, mask_logits: torch.Tensor,
                       train: bool = False, keep_masks=None):
        """RoI features + mask logits → (cls_logits, bbox_pred).  The sigmoid
        mask is resized M → warp_hw exactly as ``jax.image.resize(...,
        "linear")`` does, as two small f32 matmuls.  ``train`` turns dropout
        on; ``keep_masks`` are its optional keep-masks (see ClassifyHead)."""
        soft = torch.sigmoid(mask_logits)
        r = self.resize_mat.to(soft.dtype)
        soft14 = r @ soft @ r.T
        return self.classify_head(roi_feat, soft14, train, keep_masks)

    def _heads(self, feat: torch.Tensor, rois: torch.Tensor):
        """Both heads on the (B·N) flattened RoI set of a batch."""
        a = self.arch
        b, n = rois.shape[:2]
        roi_feat = self.warp(feat, rois)  # (B, N, 14, 14, C)
        flat = roi_feat.reshape(b * n, *roi_feat.shape[2:])
        mask_logits = self.mask_stage(flat)
        cls_logits, bbox_pred = self.classify_stage(flat, mask_logits)
        return (mask_logits.reshape(b, n, a.mask_size, a.mask_size),
                torch.softmax(cls_logits, dim=-1).reshape(b, n, -1),
                bbox_pred.reshape(b, n, -1))

    # ---- test-time cascade ----

    @torch.inference_mode()
    def apply_batch(self, images: torch.Tensor, im_infos: torch.Tensor) -> dict:
        """Image-batched cascade: (B, H, W, 3) canvases (uint8 or
        mean-subtracted float) + (B, 3) im_infos → batched outputs:

          rois         (B, N, 4)  final boxes (stage-3-refined for 5-stage)
          roi_valid    (B, N)     validity mask
          cls_prob     (B, N, C)  softmax scores (5-stage: two-pass average)
          mask_logits  (B, N, M, M) final mask logits
          bbox_pred    (B, N, 4C) deltas of the LAST classify pass
          stage3_*     the first-pass rois, cls_prob and mask_logits
        """
        a = self.arch
        with spans.span("mnc.trunk"):
            feat = self.features(images)
        with spans.span("mnc.propose", images.device):
            rpn_cls, rpn_bbox = self.rpn(feat)
            im_infos = im_infos.float()
            rois, roi_valid, _ = propose_rois(rpn_cls, rpn_bbox, im_infos, self.anchors, a)

        with spans.span("mnc.heads"):
            mask_logits, cls_prob, bbox_pred = self._heads(feat, rois)
        out_rois, out_masks, out_prob = rois, mask_logits, cls_prob
        if a.n_stages == 5:
            rois2 = (stage_bridge(rois, cls_prob, bbox_pred, im_infos, a)
                     if a.test_bbox_reg else rois)
            with spans.span("mnc.heads"):
                mask_logits2, cls_prob2, bbox_pred2 = self._heads(feat, rois2)
            out_rois, out_masks = rois2, mask_logits2
            out_prob = 0.5 * (cls_prob + cls_prob2)
            bbox_pred = bbox_pred2
        return {
            "rois": out_rois,
            "roi_valid": roi_valid,
            "cls_prob": out_prob,
            "mask_logits": out_masks,
            "bbox_pred": bbox_pred,
            "stage3_rois": rois,
            "stage3_cls_prob": cls_prob,
            "stage3_mask_logits": mask_logits,
        }

    def forward(self, image: torch.Tensor, im_info: torch.Tensor) -> dict:
        """One (H, W, 3) canvas + (3,) im_info → the outputs of
        :meth:`apply_batch` without the batch dim (the counterpart of the JAX
        ``MNC.__call__``)."""
        out = self.apply_batch(image[None], im_info[None])
        return {k: v[0] for k, v in out.items()}
