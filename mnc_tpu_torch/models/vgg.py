"""VGG-16 convolutional trunk (conv1_1 … conv5_3, stride 16) — port of the
plain path of ``mnc_tpu/models/vgg.py``.

Input convention preserved from the reference (``lib/utils/blob.py``): BGR,
mean-pixel subtracted, not scaled to [0, 1].  The public layout is NHWC, as
in the JAX package; inside, the convolutions run through cuDNN on an NCHW
view whose strides are channels-last, in the dtype of the weights (the
compute dtype).  The space-to-depth, int8 and fused block-1 variants of the
JAX package are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (name, channels) per block; pools come between blocks.
VGG16_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)


class VGG16Trunk(nn.Module):
    """(B, H, W, 3) images → (B, H/16, W/16, 512) features (NHWC), with 2×2
    max pools after blocks 1-4."""

    def __init__(self):
        super().__init__()
        cin = 3
        for block in VGG16_BLOCKS:
            for name, ch in block:
                setattr(self, name, nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1_1.weight.dtype).permute(0, 3, 1, 2)
        for b, block in enumerate(VGG16_BLOCKS):
            for name, _ in block:
                x = F.relu(getattr(self, name)(x))
            if b < 4:
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1).contiguous()
