"""int8 inference (``TEST.INT8``) — port of ``mnc_tpu/ops/quant.py``.

Under ``TEST.INT8`` the trunk convolutions (both trunks, and the per-RoI
conv5 head) and the ``fc_mask``/``fc6``/``fc7`` layers run s8 × s8 → s32:

- **weights**: symmetric per-output-channel int8, quantized from the
  unchanged float parameter (:func:`quant_weight`).  :class:`ConvInt8` and
  :class:`DenseInt8` are ``nn.Conv2d`` and ``nn.Linear`` with the same
  ``weight`` and ``bias``, so every checkpoint, npz bridge and importer
  applies unchanged; the model holds these parameters in f32, as the JAX
  package quantizes its f32 parameters.
- **activations**: symmetric dynamic (absmax) scales in the compute dtype
  (:func:`quant_act`): one per tensor for a convolution and one per row
  (RoI) for a dense layer.  A convolution's one scale covers the whole
  tensor it is given: the trunk runs on all B canvases of a batch at once
  and the conv5 head on all B·N RoIs, as in the JAX package's
  ``apply_batch``, so under int8 an image's outputs depend on the range of
  its batchmates.  (The JAX module's docstring says "per-image under the
  pipeline's vmap"; its batched path has no vmap around the trunk.)

The product accumulates exactly in int32 and is dequantized as
``acc.to(f32) * (xs * ws) + bias`` — a multiply, then a separate add — and
rounded to the compute dtype, the JAX package's order.  Both layers go
through the custom op ``mnc::gemm_s8``, which takes the int8 activations,
their scale and the FLOAT weight, and quantizes the weight inside (cached
per weight version, :func:`quantized_weight`), so that ``torch.export``
sees one opaque node: its CUDA implementation is kernel E
(``csrc/gemm_s8.cu``, bit-identical to the plain version), its CPU
implementation the plain version :func:`gemm_s8_plain`, whose float64
convolution or matmul of the int8 values is exact (every partial sum is an
integer below 2^53; the largest, 127² · 4608 ≈ 7.4·10⁷, is below 2^31 too).
The activation quantization is the custom op ``mnc::quant_act``: on the card
kernel F (``csrc/quant_act.cu``, bit-identical, one launch a call), on the CPU
:func:`quant_act`.  Where two int8 convolutions take the same input (a
ResNet bottleneck's ``conv1`` and ``proj``), it is quantized once
(:meth:`ConvInt8.quantize`, :func:`conv_int8_quantized`).  Kernel F's two
halves, the per-tensor scale alone (``mnc::act_scale``, :func:`act_scale`)
and the quantization under a given scale (``mnc::quant_with_scale``,
:func:`quant_with_scale`), serve a tensor held in parts, the spatially
sharded trunk's: the largest of the parts' scales is the whole tensor's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

_EPS = 1e-8


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` with IEEE division: by a Python scalar, PyTorch's CUDA
    kernels multiply by its reciprocal instead (an ulp off)."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quant_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float weight → (int8 weight, f32 per-output-channel scale), as the
    JAX package's ``_quant_weight``.  A conv weight (O, I, KH, KW) comes
    back as (O, KH, KW, I), kernel E's layout; a Linear weight (N, K) as
    it is."""
    w = w.detach().float()
    scale = _div127(torch.amax(w.abs(), dim=tuple(range(1, w.dim()))).clamp_min(_EPS))
    q = torch.round(w / scale.view(-1, *([1] * (w.dim() - 1)))).clamp_(-127, 127)
    q = q.to(torch.int8)
    if q.dim() == 4:
        q = q.permute(0, 2, 3, 1)
    return q.contiguous(), scale


def quant_act(x: torch.Tensor, per_row: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Activations in the compute dtype → (int8, f32 scale), as the JAX
    package's ``_quant_act``: the absmax over the whole tensor (or over the
    last axis of each row, kept as a (..., 1) column), floored at 1e-8,
    divided by 127 in the compute dtype; then ``round(x / scale)`` (half to
    even) clamped to ±127.  It is :func:`act_scale` followed by
    :func:`quant_with_scale`."""
    scale = act_scale(x, per_row)
    return quant_with_scale(x, scale), scale


def act_scale(x: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """The first half of :func:`quant_act`: the f32 scale alone, computed in
    x's dtype (so exactly a value of that dtype).  ``fl(max(m, 1e-8) / 127)``
    is monotone in the absmax m, so the scale of a tensor is the largest of
    the scales of its parts: the spatial trunk's ranks agree on one scale by
    a max over theirs."""
    if per_row:
        lo, hi = torch.aminmax(x, dim=-1, keepdim=True)
    else:
        lo, hi = torch.aminmax(x)
    return _div127(torch.maximum(-lo, hi).clamp_min(_EPS)).float()


def quant_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The second half of :func:`quant_act`: ``clamp(round(x / scale),
    ±127)`` as int8, the scale (f32, broadcast against x) cast to x's dtype
    first, which leaves a scale of :func:`act_scale` unchanged."""
    return torch.round(x / scale.to(x.dtype)).clamp_(-127, 127).to(torch.int8)


_QUANTIZED = WeakIdKeyDictionary()


def quantized_weight(w: torch.Tensor, packed: bool = False):
    """:func:`quant_weight`, cached per weight: (int8 weight, f32 scale), or
    with ``packed`` (kernel E's packed int8 weight, f32 scale).  The cache
    holds the weight weakly and is stamped with its storage, version (which
    every in-place update bumps), dtype and shape, so a reloaded or moved
    weight is quantized (and packed) anew.  Inference tensors keep no
    version counter and are quantized on every call."""
    from mnc_tpu_torch.kernels import pack_gemm_s8_weight

    stamp = (w.data_ptr(), w.device, w._version, w.dtype, tuple(w.shape))
    hit = None if w.is_inference() else _QUANTIZED.get(w)
    if hit is None or hit[0] != stamp:
        hit = (stamp, {})
        if not w.is_inference():
            _QUANTIZED[w] = hit
    forms = hit[1]
    if "int8" not in forms:
        forms["int8"] = quant_weight(w)
    if not packed:
        return forms["int8"]
    if "packed" not in forms:
        forms["packed"] = pack_gemm_s8_weight(forms["int8"][0])
    return forms["packed"], forms["int8"][1]


def dequantize(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
               bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums → ``acc.float() * (xs * ws) + bias`` in ``out_dtype``."""
    y = acc.float() * (xs * ws)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def gemm_s8_plain(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                  bias: torch.Tensor | None, stride: int = 1, padding: int = 0,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of kernel E.  A convolution: xq (B, H, W, C) int8, wq
    (Cout, KH, KW, C) int8, xs one f32 scale → (B, OH, OW, Cout); a dense
    layer: xq (M, K) int8, wq (N, K) int8, xs (M, 1) f32 → (M, N).  ws (N,)
    f32, bias (N,) or None.  The int8 products are summed in float64, which
    is exact, then cast to int32 and dequantized by :func:`dequantize`."""
    if xq.dim() == 4:
        # cuDNN may pick an FFT or Winograd algorithm, whose sums are not exact
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                           None, stride, padding)
        acc = acc.permute(0, 2, 3, 1)
    else:
        acc = xq.double() @ wq.double().T
    return dequantize(acc.to(torch.int32), xs, ws, bias, out_dtype).contiguous()


@torch.library.custom_op("mnc::gemm_s8", mutates_args=(), device_types="cpu")
def gemm_s8_op(xq: torch.Tensor, xs: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, stride: int, padding: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel E as a custom op: int8 activations ``xq`` (NHWC, or (M, K))
    and their f32 scale ``xs``, the FLOAT weight (OIHW, or (N, K)) and bias
    of the layer → its output in ``out_dtype``."""
    wq, ws = quantized_weight(weight)
    return gemm_s8_plain(xq, wq, xs, ws, bias, stride, padding, out_dtype)


@gemm_s8_op.register_kernel("cuda")
def _gemm_s8_op_cuda(xq, xs, weight, bias, stride, padding, out_dtype):
    from mnc_tpu_torch.kernels import gemm_s8_cuda

    wq, ws = quantized_weight(weight)
    wp, _ = quantized_weight(weight, packed=True)
    return gemm_s8_cuda(xq, wq, xs, ws, None if bias is None else bias.float(), stride,
                        padding, out_dtype, wp)


@gemm_s8_op.register_fake
def _gemm_s8_op_fake(xq, xs, weight, bias, stride, padding, out_dtype):
    if xq.dim() == 4:
        b, h, w, _ = xq.shape
        k = weight.shape[-1]
        oh, ow = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
        return xq.new_empty((b, oh, ow, weight.shape[0]), dtype=out_dtype)
    return xq.new_empty((xq.shape[0], weight.shape[0]), dtype=out_dtype)


@torch.library.custom_op("mnc::quant_act", mutates_args=(), device_types="cpu")
def quant_act_op(x: torch.Tensor, per_row: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F as a custom op: :func:`quant_act` with a contiguous int8
    output.  Its CUDA implementation is kernel F (``csrc/quant_act.cu``),
    its CPU implementation :func:`quant_act`."""
    q, scale = quant_act(x, per_row)
    return q.contiguous(), scale


@quant_act_op.register_kernel("cuda")
def _quant_act_op_cuda(x, per_row):
    from mnc_tpu_torch.kernels import quant_act_cuda

    return quant_act_cuda(x.contiguous(), per_row)


@quant_act_op.register_fake
def _quant_act_op_fake(x, per_row):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((*x.shape[:-1], 1) if per_row else (), dtype=torch.float32))


@torch.library.custom_op("mnc::act_scale", mutates_args=(), device_types="cpu")
def act_scale_op(x: torch.Tensor) -> torch.Tensor:
    """Kernel F's first half as a custom op: the f32 per-tensor scale of
    :func:`act_scale` (shape ``()``).  CUDA: ``kernels.act_scale_cuda``."""
    return act_scale(x, False)


@act_scale_op.register_kernel("cuda")
def _act_scale_op_cuda(x):
    from mnc_tpu_torch.kernels import act_scale_cuda

    return act_scale_cuda(x.contiguous())


@act_scale_op.register_fake
def _act_scale_op_fake(x):
    return x.new_empty((), dtype=torch.float32)


@torch.library.custom_op("mnc::quant_with_scale", mutates_args=(), device_types="cpu")
def quant_with_scale_op(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel F's second half as a custom op: x quantized under one given
    f32 scale (:func:`quant_with_scale`), a contiguous int8 tensor of x's
    shape.  CUDA: ``kernels.quant_with_scale_cuda``, whose division is
    proved for the scales :func:`act_scale` gives (a max of them included)."""
    return quant_with_scale(x, scale).contiguous()


@quant_with_scale_op.register_kernel("cuda")
def _quant_with_scale_op_cuda(x, scale):
    from mnc_tpu_torch.kernels import quant_with_scale_cuda

    return quant_with_scale_cuda(x.contiguous(), scale)


@quant_with_scale_op.register_fake
def _quant_with_scale_op_fake(x, scale):
    return x.new_empty(x.shape, dtype=torch.int8)


def conv_int8(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              stride: int = 1, padding: int = 0) -> torch.Tensor:
    """An int8 convolution of NHWC ``x`` (compute dtype) with an OIHW float
    weight (square kernel, symmetric padding) → NHWC in ``x.dtype``: one
    activation scale over all of ``x``."""
    xq, xs = quant_act_op(x, False)
    return conv_int8_quantized(xq, xs, weight, bias, stride, padding, x.dtype)


def conv_int8_quantized(xq: torch.Tensor, xs: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None, stride: int, padding: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`conv_int8` on an input already quantized by ``mnc::quant_act``
    (per tensor): NHWC int8 ``xq`` and its scale ``xs`` → NHWC in
    ``out_dtype``.  Two convolutions of one input quantize it once."""
    return gemm_s8_op(xq, xs, weight, bias, stride, padding, out_dtype)


def dense_int8(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
    """An int8 dense layer: (M, K) ``x`` (compute dtype), (N, K) float weight
    → (M, N) in ``x.dtype``, with one activation scale per row."""
    xq, xs = quant_act_op(x, True)
    return gemm_s8_op(xq, xs, weight, bias, 1, 0, x.dtype)


class ConvInt8(nn.Conv2d):
    """``nn.Conv2d`` (square kernel, symmetric padding, no dilation or
    groups) on the int8 path.  Like the float layers of the trunks it takes
    and returns an NCHW view of channels-last data, in the compute dtype."""

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``mnc::quant_act`` of an NCHW view ``x``: (NHWC int8, f32 scale),
        what :meth:`forward` takes as ``quantized``."""
        return quant_act_op(x.permute(0, 2, 3, 1), False)

    def forward(self, x: torch.Tensor, quantized: tuple | None = None) -> torch.Tensor:
        """``quantized``: ``x`` as :meth:`quantize` gives it, where another
        int8 layer on the same input has quantized it (a pre-hook still sees
        ``x``); the output is the same."""
        if quantized is None:
            y = conv_int8(x.permute(0, 2, 3, 1), self.weight, self.bias, self.stride[0],
                          self.padding[0])
        else:
            y = conv_int8_quantized(*quantized, self.weight, self.bias, self.stride[0],
                                    self.padding[0], x.dtype)
        return y.permute(0, 3, 1, 2)


class DenseInt8(nn.Linear):
    """``nn.Linear`` on the int8 path: (M, K) in the compute dtype → (M, N)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_int8(x, self.weight, self.bias)


QUANT_LAYERS = (ConvInt8, DenseInt8)
