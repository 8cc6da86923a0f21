"""Mask pooling — port of ``mnc_tpu/ops/mask_pooling.py``
(≙ ``caffe-mnc/src/caffe/layers/mask_pooling_layer``): the elementwise
product of RoI features with the resized sigmoid mask."""

from __future__ import annotations

import torch


def mask_pooling(features: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """features (N, H, W, C) * masks (N, H, W) -> (N, H, W, C)."""
    return features * masks.unsqueeze(-1).to(features.dtype)
