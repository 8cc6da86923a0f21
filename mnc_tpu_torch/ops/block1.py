"""Fused VGG block 1 — port of ``mnc_tpu/ops/pallas/block1_kernel.py``.

conv1_1 → ReLU → conv1_2 → ReLU → 2×2 max-pool, (B, H, W, 3) → (B, H/2,
W/2, 64) bf16, NHWC.  The rounding points are the contract: bf16 operands,
f32 accumulation, one rounding to bf16, then the bf16 bias add (a second
rounding), ReLU and max in bf16.  A CUDA tensor goes to kernel D
(``csrc/block1.cu``), which keeps both full-resolution intermediates on
chip; a CPU tensor goes to :func:`block1_plain`.  Weights are the trunk's
own ``conv1_1``/``conv1_2`` tensors (OIHW, any float dtype).

Gradient: as in the JAX package, whose VJP delegates to its unfused
reference, the backward of the fused call differentiates
:func:`block1_plain`.  In the training recipe block 1 is frozen, so no
backward runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def block1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel D (the JAX package's ``block1_reference``).

    The convolutions run in f32 on bf16-rounded operands, whose products
    are exact in f32, which is "bf16 operands, f32 accumulation" on any
    backend; the bias is added AFTER the rounding to bf16, in bf16, which a
    library's fused bias may not do."""
    y = conv_relu_plain(conv_relu_plain(x.to(torch.bfloat16).permute(0, 3, 1, 2), w1, b1),
                        w2, b2)
    return F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1).contiguous()


def conv_relu_plain(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 3×3 SAME convolution + bias + ReLU of :func:`block1_plain` on an
    NCHW bf16 tensor, with its rounding points."""
    bf = torch.bfloat16
    y = F.conv2d(v.float(), w.to(bf).float(), None, padding=1).to(bf)
    return F.relu(y + b.to(bf).view(1, -1, 1, 1))


def block1_tolerance(want: torch.Tensor, o1_max: float, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """What a different order of the f32 sums may do to an element of block
    1's output (..., 64), per element: one bf16 ulp (2^-7 relative) of the
    conv1_2 value BEFORE the bias add, whose magnitude is at most |out| +
    |b2| (a bias of the other sign cancels, and the ulp stays that of the
    larger number), floored at 2^-7 as in the JAX package's test; plus the
    echo of conv1_1 outputs that themselves rounded the other way (about
    5e-5 of them do): each moves a conv1_2 sum by at most one ulp of the
    largest conv1_1 output ``o1_max`` times the largest |w2|; two such
    echoes per element are allowed for."""
    ulp = 2.0 ** -7
    own = ulp * (want.float().abs() + b2.to(torch.bfloat16).float().abs()).clamp_min(1.0)
    echo = 2.0 * ulp * o1_max * w2.to(torch.bfloat16).float().abs().max().item()
    return own + echo


class Block1Function(torch.autograd.Function):
    """Kernel D forward; backward through the unfused :func:`block1_plain`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        from mnc_tpu_torch.kernels import block1_cuda

        ctx.save_for_backward(x, w1, b1, w2, b2)
        bf = torch.bfloat16
        hwio = lambda w: w.detach().to(bf).permute(2, 3, 1, 0).contiguous()  # noqa: E731
        return block1_cuda(x.detach().to(bf).contiguous(), hwio(w1), b1.detach().to(bf),
                           hwio(w2), b2.detach().to(bf))

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = block1_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_block1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """Block 1 of VGG-16 on (B, H, W, 3) images (H, W even) → (B, H/2, W/2,
    64) bf16: kernel D on the card, :func:`block1_plain` on the CPU."""
    if x.is_cuda:
        return Block1Function.apply(x, w1, b1, w2, b2)
    return block1_plain(x, w1, b1, w2, b2)
