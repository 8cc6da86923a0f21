"""Cascade heads (inference) — port of ``mnc_tpu/models/heads.py``.

- ``RPNHead`` ≙ rpn_conv/3x3 → rpn_cls_score (2A ch) + rpn_bbox_pred (4A ch).
- ``MaskHead`` ≙ fc_mask on the flattened 14×14 warped RoI features →
  MASK_SIZE² mask logits (stage 2; weights shared with stage 4).
- ``ClassifyHead`` ≙ mask pooling → 2×2 max pool → fc6/fc7 → cls_score (C)
  + bbox_pred (4C) (stage 3; weights shared with stage 5).  The
  dual-pathway variant (``NET.DUAL_PATHWAY``) is not ported yet.

Features are NHWC and are flattened in NHWC order into ``fc_mask`` and
``fc6``, as in the JAX package, so a Dense kernel (in, out) is the Linear
weight (out, in) transposed with no row permutation.  Layers compute in the
dtype of their weights and return f32 logits.  Dropout is an identity at
inference and is omitted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mnc_tpu_torch.ops.mask_pooling import mask_pooling


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 9, in_channels: int = 512,
                 mid_channels: int = 512):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(mid_channels, 2 * num_anchors, 1)
        self.rpn_bbox_pred = nn.Conv2d(mid_channels, 4 * num_anchors, 1)

    def forward(self, feat: torch.Tensor):
        """feat (B, Hf, Wf, C) → cls logits (B, Hf, Wf, 2A), bbox (B, Hf, Wf, 4A),
        both NHWC f32: channel 2a/2a+1 are anchor a's (bg, fg) logits."""
        x = feat.to(self.rpn_conv.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.rpn_conv(x))
        cls = self.rpn_cls_score(x).permute(0, 2, 3, 1).float()
        bbox = self.rpn_bbox_pred(x).permute(0, 2, 3, 1).float()
        return cls, bbox


class MaskHead(nn.Module):
    def __init__(self, in_features: int, fc_dim: int = 256, mask_size: int = 21):
        super().__init__()
        self.mask_size = mask_size
        self.fc_mask = nn.Linear(in_features, fc_dim)
        self.mask_pred = nn.Linear(fc_dim, mask_size * mask_size)

    def forward(self, roi_feat: torch.Tensor) -> torch.Tensor:
        """(N, 14, 14, C) warped features → (N, M, M) mask logits (f32)."""
        n = roi_feat.shape[0]
        x = roi_feat.to(self.fc_mask.weight.dtype).reshape(n, -1)
        x = self.mask_pred(F.relu(self.fc_mask(x)))
        return x.float().reshape(n, self.mask_size, self.mask_size)


class ClassifyHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 21, fc_dim: int = 4096,
                 pool_window: int = 2):
        super().__init__()
        self.pool_window = pool_window
        self.fc6 = nn.Linear(in_features, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, 4 * num_classes)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """2-D max pool of NHWC maps (window = stride = pool_window), flattened."""
        n, h, w, c = x.shape
        k = self.pool_window
        return x.reshape(n, h // k, k, w // k, k, c).amax(dim=(2, 4)).reshape(n, -1)

    def forward(self, roi_feat: torch.Tensor, soft_masks: torch.Tensor):
        """RoI features (N, 14, 14, C) + soft masks (N, 14, 14) → cls logits
        (N, C) and bbox deltas (N, 4C), both f32."""
        masked = mask_pooling(roi_feat, soft_masks)
        x = self._pool(masked.to(self.fc6.weight.dtype))
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        return self.cls_score(x).float(), self.bbox_pred(x).float()
