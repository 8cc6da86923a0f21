"""Spatial partitioning of the conv trunk — port of
``mnc_tpu/parallel/spatial.py``.

The image height shards over a mesh axis: each rank holds H/n rows of the
image and of every activation, and returns its H/16/n rows of the
(H/16, W/16, C) feature map.  The JAX package lets XLA's SPMD partitioner
insert the halo exchanges; here one rule serves every convolution and pool
of both trunks: output rows [a, b) of a layer with kernel k, stride s and
padding p need input rows [a·s − p, (b − 1)·s − p + k).  A rank pads only
at the image's top and bottom edge (zeros for a convolution, −inf for a
max-pool); rows inside the image always come from the rank that holds them,
through one ``all_reduce`` of a zeroed buffer with one slot per rank (every
element adds one rank's rows to zeros, which is exact).  The layer then runs
on the assembled rows with no padding along H.

Forward only (inference, as the JAX function is used): a huge image whose
activations do not fit one device.  Whatever ``model.features`` runs is
sharded.  A float convolution runs on the rank's rows with no H padding,
for which cuDNN may pick another algorithm than for the whole image, so a
float layer agrees with the unsharded one to its rounding (the sums are
the same, their order may not be); the kernels' outputs are bit for bit:

- kernel D (``NET.FUSED_BLOCK1``, bf16, where the WHOLE image's H % 8 == 0
  and W is even, the rule of ``models/vgg.py``): block 1 (two 3×3
  convolutions and a 2×2 pool) reads two rows beyond each of its output
  rows, so each rank hands D its rows and two rows of each inner
  neighbour (the rule with k = 5, s = 1, p = 2); at the image's top and
  bottom D's own zero padding is the image's.  D pads the slab's inner
  edges with zeros too, which makes the one pooled row at each inner edge
  wrong: it is dropped (the neighbour computes it).  Each output sums the
  same taps in the same order wherever its tile starts, so block 1's rows
  are D's on the whole image;
- int8 trunks (``TEST.INT8``, kernels E and F): a convolution's one
  activation scale covers the whole tensor.  ``fl(max(m, 1e-8) / 127)`` is
  monotone in the absmax m, so each rank takes its rows' scale (F's first
  half, ``mnc::act_scale``), one all-reduce of a slot buffer gives every
  rank the largest, the whole tensor's; each rank quantizes its rows under
  it (F's second half, ``mnc::quant_with_scale``) and exchanges int8 rows.
  Kernel E takes symmetric padding only: the int8 rows are zero-padded
  along W, which is exact (a zero adds nothing to an int32 sum), and E runs
  with padding 0.  A ResNet bottleneck's ``conv1`` and ``proj`` share one
  quantization, as in ``models/resnet.py``.  The result is bit for bit the
  unsharded int8 trunk's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mnc_tpu_torch.parallel.mesh import all_reduce_sum, axis_index, axis_size


class _Halo:
    """The row bookkeeping and exchange of one rank on one mesh axis."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.n, self.r = axis_size(mesh, axis), axis_index(mesh, axis)

    def rows(self, x: torch.Tensor, k: int, s: int, p: int, pad: float | None) -> torch.Tensor:
        """The input rows this rank's output rows need, from its local rows
        ``x`` (N, C, h, W) of an input of height h·n: neighbours' rows
        exchanged, ``pad`` rows beyond the image's edges (none where
        ``pad`` is None)."""
        n, r, h = self.n, self.r, x.shape[2]
        height = h * n
        out_h = (height + 2 * p - k) // s + 1
        if out_h % n:
            raise ValueError(f"output height {out_h} does not split over {n} ranks")
        oh = out_h // n

        def need(j):  # [lo, hi) of input rows that rank j's outputs read
            return (j * oh) * s - p, ((j + 1) * oh - 1) * s - p + k

        # per rank: the rows it needs above and below its own, inside the image
        needs = [need(j) for j in range(n)]
        tops = [(max(lo, 0), j * h) for j, (lo, _) in enumerate(needs)]
        bots = [((j + 1) * h, min(hi, height)) for j, (_, hi) in enumerate(needs)]
        t_max = max(max(b - a, 0) for a, b in tops)
        u_max = max(max(b - a, 0) for a, b in bots)
        lo, hi = needs[r]
        above = x.new_empty((*x.shape[:2], 0, x.shape[3]))
        below = above
        if t_max + u_max:
            buf = x.new_zeros((n, t_max + u_max, x.shape[0], x.shape[1], x.shape[3]))
            mine = (r * h, (r + 1) * h)
            for j in range(n):
                if j == r:
                    continue
                for (a, b), base in ((tops[j], 0), (bots[j], t_max)):
                    a2, b2 = max(a, mine[0]), min(b, mine[1])
                    if b2 > a2:
                        rows = x[:, :, a2 - mine[0]:b2 - mine[0]].permute(2, 0, 1, 3)
                        buf[j, base + a2 - a:base + b2 - a] = rows
            buf = all_reduce_sum(buf, self.group)
            t, u = max(tops[r][1] - tops[r][0], 0), max(bots[r][1] - bots[r][0], 0)
            above = buf[r, :t].permute(1, 2, 0, 3)
            below = buf[r, t_max:t_max + u].permute(1, 2, 0, 3)
        # rows beyond the image's edges, and rows this rank holds but does not need
        keep_lo, keep_hi = max(lo, r * h) - r * h, min(hi, (r + 1) * h) - r * h
        parts = [above, x[:, :, max(keep_lo, 0):max(keep_hi, 0)], below]
        top_pad, bot_pad = max(-lo, 0), max(hi - height, 0)
        if pad is None:
            top_pad = bot_pad = 0
        if top_pad:
            parts.insert(0, x.new_full((*x.shape[:2], top_pad, x.shape[3]), pad))
        if bot_pad:
            parts.append(x.new_full((*x.shape[:2], bot_pad, x.shape[3]), pad))
        return torch.cat(parts, dim=2)

    def conv(self, conv, x: torch.Tensor, dtype: torch.dtype, quantized=None) -> torch.Tensor:
        """``conv`` on this rank's rows ``x`` (an NCHW view); an int8 layer
        takes ``quantized`` (:meth:`quantize` of ``x``) where it is given."""
        from mnc_tpu_torch.ops.quant import ConvInt8, conv_int8_quantized

        (k, _), (s, _), (p, pw) = conv.kernel_size, conv.stride, conv.padding
        if isinstance(conv, ConvInt8):
            xq, xs = quantized if quantized is not None else self.quantize(x.to(dtype))
            xq = self.rows(xq.permute(0, 3, 1, 2), k, s, p, 0.0).permute(0, 2, 3, 1)
            if pw:  # E pads symmetrically: zero columns, then padding 0
                xq = F.pad(xq, (0, 0, pw, pw))
            y = conv_int8_quantized(xq.contiguous(), xs, conv.weight, conv.bias, s, 0, dtype)
            return y.permute(0, 3, 1, 2)
        bias = None if conv.bias is None else conv.bias.to(dtype)
        return F.conv2d(self.rows(x, k, s, p, 0.0), conv.weight.to(dtype), bias, conv.stride,
                        (0, pw))

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of an NCHW view ``x`` quantized under the scale of
        the whole tensor: (NHWC int8 rows, f32 scale), kernel F's halves on
        the card.  The scale is the largest of the ranks' (a slot each,
        one all-reduce)."""
        from mnc_tpu_torch.ops.quant import act_scale_op, quant_with_scale_op

        x = x.permute(0, 2, 3, 1)
        scale = act_scale_op(x)
        if self.n > 1:
            slots = scale.new_zeros(self.n)
            slots[self.r] = scale
            scale = all_reduce_sum(slots, self.group).max()
        return quant_with_scale_op(x, scale), scale

    def block1(self, trunk, x: torch.Tensor) -> torch.Tensor:
        """VGG block 1 through kernel D on this rank's rows and two rows of
        each inner neighbour; the pooled row at each inner edge, which D's
        zero padding spoils, is dropped."""
        from mnc_tpu_torch.ops.block1 import fused_block1

        slab = self.rows(x, 5, 1, 2, None)
        y = fused_block1(slab.permute(0, 2, 3, 1).contiguous(), trunk.conv1_1.weight,
                         trunk.conv1_1.bias,
                         trunk.conv1_2.weight, trunk.conv1_2.bias).permute(0, 3, 1, 2)
        return y[:, :, int(self.r > 0):y.shape[2] - int(self.r < self.n - 1)]

    def max_pool(self, x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
        return F.max_pool2d(self.rows(x, k, s, p, -math.inf), k, s, (0, p))


def _vgg(trunk, x, ex: _Halo):
    from mnc_tpu_torch.models.vgg import VGG16_BLOCKS

    cd = trunk.compute_dtype
    for b, block in enumerate(VGG16_BLOCKS):
        if (b == 0 and trunk.fused_block1 and cd == torch.bfloat16
                and x.shape[2] * ex.n % 8 == 0 and x.shape[3] % 2 == 0):
            x = ex.block1(trunk, x)  # the whole image's shape rule, as models/vgg.py
            continue
        for name, _ in block:
            x = F.relu(ex.conv(getattr(trunk, name), x, cd))
        if b < 4:
            x = ex.max_pool(x, 2, 2, 0)
    return x


def _bottleneck(blk, x, ex: _Halo):
    from mnc_tpu_torch.ops.quant import ConvInt8

    cd = blk.compute_dtype
    proj = getattr(blk, "proj", None)
    xq = None
    if isinstance(proj, ConvInt8) and isinstance(blk.conv1, ConvInt8):
        x = x.to(cd)
        xq = ex.quantize(x)  # conv1 and proj take the same x: quantize it once
    y = F.relu(blk.bn1(ex.conv(blk.conv1, x, cd, xq)))
    y = F.relu(blk.bn2(ex.conv(blk.conv2, y, cd)))
    y = blk.bn3(ex.conv(blk.conv3, y, cd))
    residual = blk.bn_proj(ex.conv(proj, x, cd, xq)) if proj is not None else x
    return F.relu(y + residual)


def _resnet(trunk, x, ex: _Halo):
    x = F.relu(trunk.bn1(ex.conv(trunk.conv1, x, trunk.compute_dtype)))
    x = ex.max_pool(x, 3, 2, 1)  # the implicit -inf padding of the stem's pool
    for blocks in trunk.stages:
        for blk in blocks:
            x = _bottleneck(blk, x, ex)
    return x


def spatial_trunk_features(model, mesh, axis: str = "data"):
    """``fn(rows)``: ``model.features`` with the image height sharded over
    ``axis``, kernel D and int8 layers included.  ``rows`` are this rank's
    (H/n, W, 3) rows of the image (:func:`shard_image`; a leading batch axis
    may come first); returns this rank's (H/16/n, W/16, C) rows of the
    feature map.  H must be a multiple of n·16."""
    from mnc_tpu_torch.models.resnet import ResNetTrunk
    from mnc_tpu_torch.models.vgg import VGG16Trunk
    from mnc_tpu_torch.utils.blob import device_normalize

    trunk, ex = model.trunk, _Halo(mesh, axis)
    if not isinstance(trunk, (VGG16Trunk, ResNetTrunk)):
        raise ValueError(f"spatial_trunk_features: no halo rule for {type(trunk).__name__}")
    run = _vgg if isinstance(trunk, VGG16Trunk) else _resnet

    @torch.no_grad()
    def fn(rows: torch.Tensor) -> torch.Tensor:
        single = rows.dim() == 3
        x = rows[None] if single else rows
        if x.shape[1] % 16:
            raise ValueError(f"spatial_trunk_features: H = {x.shape[1] * ex.n} is not a "
                             f"multiple of {ex.n}·16 ({ex.n} ranks)")
        x = device_normalize(x).to(trunk.compute_dtype).permute(0, 3, 1, 2)
        y = run(trunk, x, ex).permute(0, 2, 3, 1).contiguous()
        return y[0] if single else y

    return fn


def shard_image(image, mesh, axis: str = "data"):
    """This rank's rows of one (H, W, 3) image (numpy or torch)."""
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    h = image.shape[0]
    if h % (n * 16):
        raise ValueError(f"shard_image: H = {h} is not a multiple of {n}·16 "
                         f"({n} ranks, feature stride 16)")
    return image[r * (h // n):(r + 1) * (h // n)]
