"""Cascade heads — port of ``mnc_tpu/models/heads.py``.

- ``RPNHead`` ≙ rpn_conv/3x3 → rpn_cls_score (2A ch) + rpn_bbox_pred (4A ch).
- ``MaskHead`` ≙ fc_mask on the flattened 14×14 warped RoI features →
  MASK_SIZE² mask logits (stage 2; weights shared with stage 4).
- ``ClassifyHead`` ≙ mask pooling → 2×2 max pool → fc6/fc7 → cls_score (C)
  + bbox_pred (4C) (stage 3; weights shared with stage 5).  With
  ``dual_pathway`` (``NET.DUAL_PATHWAY``) the raw RoI features are pooled
  beside the mask-pooled ones and concatenated after them before fc6.

The ResNet per-RoI conv5 head is ``models/resnet.py::ConvRoIHead``.

Features are NHWC and are flattened in NHWC order into ``fc_mask`` and
``fc6``, as in the JAX package, so a Dense kernel (in, out) is the Linear
weight (out, in) transposed with no row permutation.  Layers cast their
weights to ``compute_dtype`` in ``forward`` (a no-op when they are held in
it) and return f32 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mnc_tpu_torch.models.vgg import conv_cast
from mnc_tpu_torch.ops.mask_pooling import mask_pooling


def linear_cast(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, fc.weight.to(dtype), fc.bias.to(dtype))


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 9, in_channels: int = 512,
                 mid_channels: int = 512, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.rpn_conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(mid_channels, 2 * num_anchors, 1)
        self.rpn_bbox_pred = nn.Conv2d(mid_channels, 4 * num_anchors, 1)

    def forward(self, feat: torch.Tensor):
        """feat (B, Hf, Wf, C) → cls logits (B, Hf, Wf, 2A), bbox (B, Hf, Wf, 4A),
        both NHWC f32: channel 2a/2a+1 are anchor a's (bg, fg) logits."""
        cd = self.compute_dtype
        x = feat.to(cd).permute(0, 3, 1, 2)
        x = F.relu(conv_cast(self.rpn_conv, x, cd))
        cls = conv_cast(self.rpn_cls_score, x, cd).permute(0, 2, 3, 1).float()
        bbox = conv_cast(self.rpn_bbox_pred, x, cd).permute(0, 2, 3, 1).float()
        return cls, bbox


class MaskHead(nn.Module):
    def __init__(self, in_features: int, fc_dim: int = 256, mask_size: int = 21,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mask_size = mask_size
        self.fc_mask = nn.Linear(in_features, fc_dim)
        self.mask_pred = nn.Linear(fc_dim, mask_size * mask_size)

    def forward(self, roi_feat: torch.Tensor) -> torch.Tensor:
        """(N, 14, 14, C) warped features → (N, M, M) mask logits (f32)."""
        cd = self.compute_dtype
        n = roi_feat.shape[0]
        x = roi_feat.to(cd).reshape(n, -1)
        x = linear_cast(self.mask_pred, F.relu(linear_cast(self.fc_mask, x, cd)), cd)
        return x.float().reshape(n, self.mask_size, self.mask_size)


class ClassifyHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 21, fc_dim: int = 4096,
                 pool_window: int = 2, compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.5, dual_pathway: bool = False):
        """``in_features``: the pooled, flattened width of one pathway."""
        super().__init__()
        self.compute_dtype = compute_dtype
        self.pool_window = pool_window
        self.dropout_rate = dropout_rate
        self.fc_dim = fc_dim
        self.dual_pathway = dual_pathway
        self.fc6 = nn.Linear(in_features * (2 if dual_pathway else 1), fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, 4 * num_classes)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """2-D max pool of NHWC maps (window = stride = pool_window), flattened.
        ``max_pool2d`` hands a window's gradient to its FIRST maximum, as the
        JAX package's ``nn.max_pool`` does (``amax`` would split it among
        ties, which are common: windows of post-ReLU zeros)."""
        k = self.pool_window
        y = F.max_pool2d(x.permute(0, 3, 1, 2), k, k)
        return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def _dropout(self, x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        """flax's Dropout: kept units are divided by the keep probability."""
        keep_prob = 1.0 - self.dropout_rate
        if keep is None:
            keep = torch.rand(x.shape, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, x.new_zeros(()))

    def forward(self, roi_feat: torch.Tensor, soft_masks: torch.Tensor,
                train: bool = False, keep_masks=None):
        """RoI features (N, 14, 14, C) + soft masks (N, 14, 14) → cls logits
        (N, C) and bbox deltas (N, 4C), both f32.  With ``train``, dropout
        follows ``fc6`` and ``fc7``; ``keep_masks`` is an optional pair of
        (N, fc_dim) bool keep-masks (drawn here from the global generator
        when absent)."""
        cd = self.compute_dtype
        paths = [mask_pooling(roi_feat, soft_masks)]
        if self.dual_pathway:
            paths.append(roi_feat)
        x = torch.cat([self._pool(p.to(cd)) for p in paths], dim=-1)
        k6, k7 = keep_masks if keep_masks is not None else (None, None)
        x = F.relu(linear_cast(self.fc6, x, cd))
        if train:
            x = self._dropout(x, k6)
        x = F.relu(linear_cast(self.fc7, x, cd))
        if train:
            x = self._dropout(x, k7)
        return (linear_cast(self.cls_score, x, cd).float(),
                linear_cast(self.bbox_pred, x, cd).float())
