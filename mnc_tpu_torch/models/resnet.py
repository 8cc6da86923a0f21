"""ResNet trunk (stride 16, conv4 feature) and the per-RoI conv5 classify
head — port of ``mnc_tpu/models/resnet.py``, the backbone of MNC's COCO
2015 entry.

Bottleneck ResNet-50/101/152 with BatchNorm frozen into an affine
(``FrozenBN``: the running statistics are folded into ``scale`` and
``bias``, as detection fine-tuning froze BN).  The parameter names are the
JAX package's: ``conv1``, ``bn1``, ``stage{2..4}_block{i}`` with
``conv1..3``, ``bn1..3``, ``proj``, ``bn_proj`` inside, and the leaves
``scale`` and ``bias``.  Convolutions have no bias and symmetric ``k // 2``
padding (flax's "SAME" would pad asymmetrically at stride 2).

The public layout is NHWC; inside, the convolutions run on an NCHW view
whose strides are channels-last (cuDNN's NHWC kernels on the card).  Every
layer casts its parameters to ``compute_dtype`` in ``forward``, as
``models/vgg.py`` does.  FrozenBN keeps the JAX package's order of
operations, ``x * scale + bias`` with each step rounded to the compute
dtype; it is not folded into the convolutions.  Under ``int8``
(``TEST.INT8``, inference only) every convolution — the stem, the 1×1 and
3×3 convolutions at stride 1 and 2 and the projections, in the trunk and in
the conv5 head — is a :class:`~mnc_tpu_torch.ops.quant.ConvInt8` with the
same parameters; FrozenBN, the residual add and the ReLUs are unchanged.
A block's ``conv1`` and ``proj`` share one quantization of its input.
The head's convolutions take one activation scale over all the RoIs they
are given (B·N in ``MNC.apply_batch``), as in the JAX package.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from mnc_tpu_torch.models.heads import linear_cast
from mnc_tpu_torch.models.vgg import conv_cast
from mnc_tpu_torch.ops.mask_pooling import mask_pooling
from mnc_tpu_torch.ops.quant import ConvInt8

_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FrozenBN(nn.Module):
    """Affine-only BatchNorm on NCHW views.  ``zero_scale`` initializes the
    scale to 0 (the last BN of each bottleneck, "zero-gamma"), so that every
    residual block starts as its shortcut; :class:`MNC` applies the init."""

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return x * self.scale.to(cd).view(1, -1, 1, 1) + self.bias.to(cd).view(1, -1, 1, 1)


def _conv(cin: int, cout: int, k: int, stride: int, int8: bool = False) -> nn.Conv2d:
    return (ConvInt8 if int8 else nn.Conv2d)(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 (×4 channels) with FrozenBN, plus a projection
    shortcut when ``project``.  ``stride_in_3x3`` must match the weights'
    source: False is v1 (stride on the first 1×1, the MSRA release), True is
    v1.5 (stride on the 3×3, torchvision's checkpoints)."""

    def __init__(self, cin: int, features: int, stride: int = 1, project: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, stride_in_3x3: bool = False,
                 int8: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        s1, s2 = (1, stride) if stride_in_3x3 else (stride, 1)
        f, cd = features, compute_dtype
        self.conv1 = _conv(cin, f, 1, s1, int8)
        self.bn1 = FrozenBN(f, cd)
        self.conv2 = _conv(f, f, 3, s2, int8)
        self.bn2 = FrozenBN(f, cd)
        self.conv3 = _conv(f, 4 * f, 1, 1, int8)
        self.bn3 = FrozenBN(4 * f, cd, zero_scale=True)
        if project:
            self.proj = _conv(cin, 4 * f, 1, stride, int8)
            self.bn_proj = FrozenBN(4 * f, cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        xq = None
        if hasattr(self, "proj") and isinstance(self.conv1, ConvInt8) and \
                isinstance(self.proj, ConvInt8):
            x = x.to(cd)
            xq = self.conv1.quantize(x)  # conv1 and proj take the same x: quantize it once
        y = F.relu(self.bn1(self._conv(self.conv1, x, xq)))
        y = F.relu(self.bn2(conv_cast(self.conv2, y, cd)))
        y = self.bn3(conv_cast(self.conv3, y, cd))
        residual = self.bn_proj(self._conv(self.proj, x, xq)) if hasattr(self, "proj") else x
        return F.relu(y + residual)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor, xq) -> torch.Tensor:
        return conv_cast(conv, x, self.compute_dtype) if xq is None else conv(x, quantized=xq)


def _stage(module: nn.Module, name: str, n_blocks: int, cin: int, features: int, stride: int,
           compute_dtype: torch.dtype, stride_in_3x3: bool, int8: bool) -> list:
    """Adds blocks ``{name}_block{i}`` to ``module``; returns them."""
    blocks = []
    for i in range(n_blocks):
        blk = Bottleneck(cin if i == 0 else 4 * features, features, stride if i == 0 else 1,
                         i == 0, compute_dtype, stride_in_3x3, int8)
        setattr(module, f"{name}_block{i}", blk)
        blocks.append(blk)
    return blocks


class ResNetTrunk(nn.Module):
    """(B, H, W, 3) images → (B, H/16, W/16, 1024) conv4 features (NHWC).

    ``frozen_stages`` stops the gradient after the stem (≥ 1) and after each
    stage s ≤ ``frozen_stages`` (stages 2-4), as the JAX package's
    ``stop_gradient``: their parameters get no gradient."""

    out_channels = 1024

    def __init__(self, depth: int = 101, compute_dtype: torch.dtype = torch.bfloat16,
                 frozen_stages: int = 1, stride_in_3x3: bool = False, int8: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.frozen_stages = frozen_stages
        self.conv1 = _conv(3, 64, 7, 2, int8)
        self.bn1 = FrozenBN(64, compute_dtype)
        cin = 64
        self.stages = []  # plain lists: the blocks are registered by name above
        for s, (n_blocks, f) in enumerate(zip(_DEPTHS[depth][:3], (64, 128, 256))):
            self.stages.append(_stage(self, f"stage{s + 2}", n_blocks, cin, f,
                                      1 if s == 0 else 2, compute_dtype, stride_in_3x3, int8))
            cin = 4 * f

    def _frozen(self, stage: int):
        return torch.no_grad() if self.frozen_stages >= stage else contextlib.nullcontext()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)
        with self._frozen(1):
            x = F.relu(self.bn1(conv_cast(self.conv1, x, cd)))
            x = F.max_pool2d(x, 3, 2, padding=1)  # implicit -inf padding
        for s, blocks in enumerate(self.stages):
            with self._frozen(s + 2):
                for blk in blocks:
                    x = blk(x)
        return x.permute(0, 2, 3, 1).contiguous()


class ConvRoIHead(nn.Module):
    """The per-RoI conv5 classify head of MNC's COCO entry: mask pooling →
    the conv5 stage (block 0 strides 14 → 7) → global mean → ``cls_score``
    (C) and ``bbox_pred`` (4C), both f32 out.  Replaces the fc6/fc7 tower
    (``NET.ROI_CONV5``); it has no dropout."""

    def __init__(self, num_classes: int = 21, depth: int = 101, in_channels: int = 1024,
                 compute_dtype: torch.dtype = torch.bfloat16, stride_in_3x3: bool = False,
                 int8: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.blocks = _stage(self, "stage5", _DEPTHS[depth][3], in_channels, 512, 2,
                             compute_dtype, stride_in_3x3, int8)
        self.cls_score = nn.Linear(2048, num_classes)
        self.bbox_pred = nn.Linear(2048, 4 * num_classes)

    def forward(self, roi_feat: torch.Tensor, soft_masks: torch.Tensor, train: bool = False,
                keep_masks=None):
        """(N, 14, 14, C) warped features + (N, 14, 14) soft masks → cls
        logits (N, C) and bbox deltas (N, 4C).  ``train`` and ``keep_masks``
        are the fc head's dropout arguments, accepted and ignored."""
        cd = self.compute_dtype
        x = mask_pooling(roi_feat, soft_masks).to(cd).permute(0, 3, 1, 2)
        for blk in self.blocks:
            x = blk(x)
        # the mean is summed in (at least) f32 and rounded once, as jnp.mean
        x = x.mean(dim=(2, 3), dtype=torch.promote_types(cd, torch.float32)).to(cd)
        return (linear_cast(self.cls_score, x, cd).float(),
                linear_cast(self.bbox_pred, x, cd).float())
