"""Fused VGG block 1 — port of ``mnc_tpu/ops/pallas/block1_kernel.py``.

conv1_1 → ReLU → conv1_2 → ReLU → 2×2 max-pool, (B, H, W, 3) → (B, H/2,
W/2, 64) bf16, NHWC.  The rounding points are the contract: bf16 operands,
f32 accumulation, one rounding to bf16, then the bf16 bias add (a second
rounding), ReLU and max in bf16.  A CUDA tensor goes to kernel D
(``csrc/block1.cu``), which keeps both full-resolution intermediates on
chip; a CPU tensor goes to :func:`block1_plain`.  Weights are the trunk's
own ``conv1_1``/``conv1_2`` tensors (OIHW, any float dtype); the kernel
reads them in its own layout (:func:`pack_block1_weights`), packed once per
weight version (:func:`packed_block1_weights`).  Without a gradient the call
goes through the custom op ``mnc::block1``, which takes the OIHW weights and
packs them inside its CUDA implementation, so that ``torch.export`` sees one
opaque node and none of the packing cache.

Gradient: as in the JAX package, whose VJP delegates to its unfused
reference, the backward of the fused call differentiates
:func:`block1_plain`.  In the training recipe block 1 is frozen, so no
backward runs.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

# Kernel D's conv1_2 B tile: packed column n holds output channel
# 16 * ((n % 8) // 2) + 2 * (n // 8) + n % 2, so that the wgmma accumulator
# fragment of lane q (columns 8j + 2q + {0, 1}, j = 0..7) holds channels
# 16q .. 16q+15 in order.
_COL = torch.arange(64)
CHANNEL_OF_COLUMN = 16 * ((_COL % 8) // 2) + 2 * (_COL // 8) + _COL % 2
# 128-byte swizzle: 16-byte chunk c of row n lies at chunk c ^ (n % 8)
_SWIZZLED_CHUNK = torch.arange(8)[None, :] ^ (_COL[:, None] % 8)  # (64 rows, 8 chunks)


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


def pack_block1_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor):
    """Kernel D's operands from OIHW weights (any float dtype), all bf16:

    - w1p (64, 32): [output channel][k = (ky * 3 + kx) * 3 + ci], zero for
      k >= 27 (conv1_1's im2col, K padded to 32);
    - w2p (9, 64, 64): per tap ky * 3 + kx, conv1_2's B tile in the layout a
      wgmma shared-memory descriptor reads (K-major, 128-byte rows, 128-byte
      swizzle), row n holding output channel ``CHANNEL_OF_COLUMN[n]``;
    - b1, b2 (64,) cast.
    """
    bf = torch.bfloat16
    w1p = torch.zeros(64, 32, dtype=bf, device=w1.device)
    w1p[:, :27] = w1.detach().to(bf).permute(0, 2, 3, 1).reshape(64, 27)
    taps = w2.detach().to(bf).permute(2, 3, 0, 1).reshape(9, 64, 8, 8)  # tap, co, chunk, ci % 8
    taps = taps[:, CHANNEL_OF_COLUMN.to(w2.device)]
    w2p = torch.empty_like(taps)
    rows = _COL.to(w2.device)[:, None]
    w2p[:, rows, _SWIZZLED_CHUNK.to(w2.device)] = taps
    return (w1p, b1.detach().to(bf).contiguous(), w2p.reshape(9, 64, 64),
            b2.detach().to(bf).contiguous())


_PACKED: dict = {}


def packed_block1_weights(w1, b1, w2, b2):
    """:func:`pack_block1_weights`, cached per weight version: the cache
    holds the tensors weakly and is keyed on their storage and ``_version``,
    which every in-place update (an optimizer step, ``copy_``) bumps.
    Inference tensors (made under ``torch.inference_mode``) keep no version
    counter, so their packing is made anew on every call."""
    ts = (w1, b1, w2, b2)
    if any(t.is_inference() for t in ts):
        return pack_block1_weights(*ts)
    key = tuple(t.data_ptr() for t in ts)
    stamp = tuple((t._version, t.dtype, t.shape) for t in ts)
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == stamp and all(r() is t for r, t in zip(hit[0], ts)):
        return hit[2]
    if len(_PACKED) >= 8:
        _PACKED.clear()
    packed = pack_block1_weights(*ts)
    _PACKED[key] = (tuple(weakref.ref(t) for t in ts), stamp, packed)
    return packed


@torch.library.custom_op("mnc::block1", mutates_args=(), device_types="cpu")
def block1_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """Kernel D as a custom op: (B, H, W, 3) images and OIHW weights →
    (B, H/2, W/2, 64) bf16."""
    return block1_plain(x, w1, b1, w2, b2)


@block1_op.register_kernel("cuda")
def _block1_op_cuda(x, w1, b1, w2, b2):
    from mnc_tpu_torch.kernels import block1_cuda

    return block1_cuda(x.to(torch.bfloat16).contiguous(),
                       *packed_block1_weights(w1, b1, w2, b2))


@block1_op.register_fake
def _block1_op_fake(x, w1, b1, w2, b2):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16)


class Block1Function(torch.autograd.Function):
    """Kernel D forward; backward through the unfused :func:`block1_plain`.
    The last four arguments are the packed weights (no gradient)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, *packed):
        from mnc_tpu_torch.kernels import block1_cuda

        ctx.save_for_backward(x, w1, b1, w2, b2)
        w1p, b1p, w2p, b2p = packed
        return block1_cuda(x.detach().to(torch.bfloat16).contiguous(), w1p, b1p, w2p, b2p)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = block1_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 4


def fused_block1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """Block 1 of VGG-16 on (B, H, W, 3) images (H, W even) → (B, H/2, W/2,
    64) bf16: kernel D on the card, :func:`block1_plain` on the CPU."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2))):
        return block1_op(x, w1, b1, w2, b2)
    if x.is_cuda:
        return Block1Function.apply(x, w1, b1, w2, b2,
                                    *packed_block1_weights(w1, b1, w2, b2))
    return block1_plain(x, w1, b1, w2, b2)
