"""VGG-16 convolutional trunk (conv1_1 … conv5_3, stride 16) — port of
``mnc_tpu/models/vgg.py``.

Input convention preserved from the reference (``lib/utils/blob.py``): BGR,
mean-pixel subtracted, not scaled to [0, 1].  The public layout is NHWC, as
in the JAX package; inside, the convolutions run through cuDNN on an NCHW
view whose strides are channels-last.  Every layer casts its weights to
``compute_dtype`` in ``forward``: a no-op when the module holds them in that
dtype already (serving), the flax ``param_dtype=float32`` /
``dtype=compute_dtype`` split when it holds f32 master parameters
(training).

``frozen_blocks`` stops gradients into the first N blocks, as the JAX
package's ``stop_gradient`` on their activations: their parameters get no
gradient (the optimizer still decays their kernels).  ``fused_block1`` runs
block 1 through :func:`mnc_tpu_torch.ops.block1.fused_block1` when the
shape rule holds (H % 8 == 0 and W % 2 == 0, the JAX package's rule); any
other shape takes the unfused layers, whatever the device.  ``int8``
(``TEST.INT8``, inference only) makes every convolution a
:class:`~mnc_tpu_torch.ops.quant.ConvInt8` (kernel E on the card) with the
same parameters; ReLU and the pools are unchanged, and ``fused_block1`` is
then ignored, as in the JAX package.  The space-to-depth variant of the JAX
package (the same math in another layout of block 1) is not ported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from mnc_tpu_torch.ops.block1 import fused_block1
from mnc_tpu_torch.ops.quant import ConvInt8

# (name, channels) per block; pools come between blocks.
VGG16_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)


def conv_cast(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` applied with its weight and bias (if any) cast to ``dtype``;
    an int8 layer quantizes ``x`` in ``dtype`` and returns ``dtype``."""
    if isinstance(conv, ConvInt8):
        return conv(x.to(dtype))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias, conv.stride, conv.padding)


class VGG16Trunk(nn.Module):
    """(B, H, W, 3) images → (B, H/16, W/16, 512) features (NHWC), with 2×2
    max pools after blocks 1-4."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 frozen_blocks: int = 2, fused_block1: bool = False, int8: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.frozen_blocks = frozen_blocks
        self.fused_block1 = fused_block1 and not int8
        conv = ConvInt8 if int8 else nn.Conv2d
        cin = 3
        for block in VGG16_BLOCKS:
            for name, ch in block:
                setattr(self, name, conv(cin, ch, 3, padding=1))
                cin = ch

    def _block(self, b: int, x: torch.Tensor) -> torch.Tensor:
        """Block ``b`` on an NCHW view, pool included."""
        cd = self.compute_dtype
        if (b == 0 and self.fused_block1 and cd == torch.bfloat16
                and x.shape[2] % 8 == 0 and x.shape[3] % 2 == 0):
            y = fused_block1(x.permute(0, 2, 3, 1), self.conv1_1.weight, self.conv1_1.bias,
                             self.conv1_2.weight, self.conv1_2.bias)
            return y.permute(0, 3, 1, 2)
        for name, _ in VGG16_BLOCKS[b]:
            x = F.relu(conv_cast(getattr(self, name), x, cd))
        return F.max_pool2d(x, 2, 2) if b < 4 else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for b in range(len(VGG16_BLOCKS)):
            frozen = b < self.frozen_blocks
            with torch.no_grad() if frozen else contextlib.nullcontext():
                x = self._block(b, x)
        return x.permute(0, 2, 3, 1).contiguous()
