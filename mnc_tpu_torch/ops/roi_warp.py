"""RoI warping — port of ``mnc_tpu/ops/roi_warp.py``.

Differentiable bilinear crop-and-resize of RoIs from NHWC feature maps, the
reference ``roi_warping_layer``: gradients reach the features and the box
coordinates (the path that makes MNC a cascade).  Sampling convention (Caffe-compatible):
pixel centers at integer coordinates, RoI width with the +1 convention, and
bin (p, q) of RoI (x1, y1, x2, y2) samples at

    yc = y1*s + (p + 0.5) * (y2 - y1 + 1) * s / PH - 0.5
    xc = x1*s + (q + 0.5) * (x2 - x1 + 1) * s / PW - 0.5

with zero contribution outside the feature map.  A CUDA tensor goes to
kernel A (``csrc/roi_warp.cu``, a direct 4-tap gather) and, when a gradient
is required, through :class:`RoIWarpFunction`, whose backward is kernel A′
(``csrc/roi_warp_bwd.cu``); a CPU tensor goes to :func:`roi_warp_plain`, the
JAX package's hat-matrix einsum, differentiated by autograd.  Without a
gradient the call goes through the custom op ``mnc::roi_warp`` (kernel A on
CUDA, the plain version on the CPU, a fake for tracing), which
``torch.export`` keeps as one opaque node.  :func:`roi_pool` is the
Fast-RCNN quantized max pooling, plain PyTorch on either device (the JAX
package's is plain ``jnp`` too).
"""

from __future__ import annotations

import torch


def unit_grid(out_size: int, device) -> torch.Tensor:
    """(P,) f32 bin centers (i + 0.5) / P of the unit interval.  The divisor
    is a tensor: by a Python scalar, PyTorch's CUDA kernels multiply by the
    reciprocal instead, which is an ulp off the IEEE quotient that the CPU,
    JAX and the CUDA kernels compute (enough to move a coordinate off an
    integer, where the gradient of the hat function jumps)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    return (i + 0.5) / torch.full_like(i, float(out_size))


def bin_centers(rois: torch.Tensor, out_size: int, spatial_scale: float, axis: int):
    """(..., N, 4) image-coordinate rois → (..., N, P) f32 feature-space
    coords of the bin centers along one axis (0 = y, 1 = x)."""
    lo = rois[..., 1] if axis == 0 else rois[..., 0]
    hi = rois[..., 3] if axis == 0 else rois[..., 2]
    span = (hi - lo + 1.0) * spatial_scale
    grid = unit_grid(out_size, rois.device)
    return lo.unsqueeze(-1) * spatial_scale + grid * span.unsqueeze(-1) - 0.5


def interp_matrix(centers: torch.Tensor, src_size: int) -> torch.Tensor:
    """Hat-function interpolation weights (..., P, S) for coords (..., P).

    The subgradients are JAX's, so that both packages agree at an integer
    coordinate too: ``torch.maximum`` (not ``clamp_min``) passes half of the
    gradient where the weight is exactly 0, as ``jnp.maximum`` does, and |d|
    is written as a select whose derivative at 0 is +1, as ``jnp.abs``'s is
    (``Tensor.abs`` has 0 there)."""
    src = torch.arange(src_size, dtype=torch.float32, device=centers.device)
    d = centers.unsqueeze(-1) - src
    hat = 1.0 - torch.where(d >= 0, d, -d)
    return torch.maximum(hat, hat.new_zeros(()))


def roi_warp_plain(features: torch.Tensor, rois: torch.Tensor, out_hw,
                   spatial_scale: float) -> torch.Tensor:
    """Plain twin of kernel A: the JAX package's ``_warp_einsum``, batched.

    features (B, H, W, C), rois (B, N, 4) → (B, N, PH, PW, C).  Hats and the
    x-pass intermediate are rounded to the feature dtype, as in JAX;
    products accumulate in f32.
    """
    ph, pw = out_hw
    _, h, w, _ = features.shape
    dt = features.dtype
    wy = interp_matrix(bin_centers(rois, ph, spatial_scale, 0), h)  # (B, N, PH, H)
    wx = interp_matrix(bin_centers(rois, pw, spatial_scale, 1), w)  # (B, N, PW, W)
    f32 = features.float()
    # x first: (B, N, PW, W) x (B, H, W, C) -> (B, N, H, PW, C)
    tmp = torch.einsum("bnqw,bhwc->bnhqc", wx.to(dt).float(), f32).to(dt)
    out = torch.einsum("bnph,bnhqc->bnpqc", wy.to(dt).float(), tmp.float())
    return out.to(dt)


@torch.library.custom_op("mnc::roi_warp", mutates_args=(), device_types="cpu")
def roi_warp_op(features: torch.Tensor, rois: torch.Tensor, out_h: int, out_w: int,
                spatial_scale: float) -> torch.Tensor:
    """Kernel A as a custom op: contiguous features (B, H, W, C), f32 rois
    (B, N, 4) → (B, N, out_h, out_w, C) in the feature dtype."""
    return roi_warp_plain(features, rois, (out_h, out_w), spatial_scale)


@roi_warp_op.register_kernel("cuda")
def _roi_warp_op_cuda(features, rois, out_h, out_w, spatial_scale):
    from mnc_tpu_torch.kernels import roi_warp_cuda

    return roi_warp_cuda(features, rois, (out_h, out_w), spatial_scale)


@roi_warp_op.register_fake
def _roi_warp_op_fake(features, rois, out_h, out_w, spatial_scale):
    b, n = rois.shape[:2]
    return features.new_empty((b, n, out_h, out_w, features.shape[-1]))


class RoIWarpFunction(torch.autograd.Function):
    """Kernel A forward, kernel A′ backward (CUDA tensors only).

    Both gradients are summed in an order that the inputs alone fix, so a
    backward on the same inputs gives the same bits every time: the
    gradient to the features by map tile, over the RoIs listed for the tile
    in ascending index (``kernels.roi_warp_bwd_lists``), in f32, rounded
    once; the gradient to the rois by a fixed-order reduction per RoI.
    Subgradients follow the hat form max(0, 1 - |c - h|) as JAX (and
    :func:`interp_matrix` under autograd) differentiate it: a tap outside
    the map contributes nothing; at an integer coordinate c the tap at c has
    derivative -1 and its two neighbours, whose weight is exactly 0, have
    half of theirs."""

    @staticmethod
    def forward(ctx, features, rois, out_hw, spatial_scale):
        from mnc_tpu_torch.kernels import roi_warp_cuda

        ctx.save_for_backward(features, rois)
        ctx.spatial_scale = spatial_scale
        return roi_warp_cuda(features, rois, out_hw, spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        from mnc_tpu_torch.kernels import roi_warp_bwd_cuda

        features, rois = ctx.saved_tensors
        dfeat, drois = roi_warp_bwd_cuda(grad_out.to(features.dtype).contiguous(),
                                         features, rois, ctx.spatial_scale)
        return (dfeat if ctx.needs_input_grad[0] else None,
                drois if ctx.needs_input_grad[1] else None, None, None)


def roi_warp(features: torch.Tensor, rois: torch.Tensor,
             out_hw: tuple[int, int] = (14, 14),
             spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Bilinear crop-and-resize of RoIs from feature maps.

    Args:
      features: (B, H, W, C) feature maps (or one (H, W, C) map).
      rois: (B, N, 4) boxes (x1, y1, x2, y2) in IMAGE coordinates (or (N, 4)
        with one map).
      out_hw: output resolution (PH, PW).
      spatial_scale: feature-grid scale (1/16 for a stride-16 trunk).

    Returns (B, N, PH, PW, C) in the feature dtype (no batch dim for one
    map); gradients flow to ``features`` and ``rois``.
    """
    single = features.dim() == 3
    if single:
        features, rois = features.unsqueeze(0), rois.unsqueeze(0)
    if not (torch.is_grad_enabled() and (features.requires_grad or rois.requires_grad)):
        out = roi_warp_op(features.contiguous(), rois.float().contiguous(), *out_hw,
                          spatial_scale)
    elif features.is_cuda:
        out = RoIWarpFunction.apply(features.contiguous(), rois.float().contiguous(),
                                    tuple(out_hw), spatial_scale)
    else:
        out = roi_warp_plain(features, rois.float(), out_hw, spatial_scale)
    return out[0] if single else out


def c_round(x: torch.Tensor) -> torch.Tensor:
    """C/C++ ``std::round``: half AWAY from zero, what the Caffe layer used
    (``torch.round`` is half-to-even, which flips every corner landing
    exactly on a .5 feature coordinate, e.g. x = 8 at stride 16)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _bin_mask(lo: torch.Tensor, rsz: torch.Tensor, src_size: int, nbins: int) -> torch.Tensor:
    """(N,) int bin origins and extents → (N, S, P) bool: cell s lies in
    [lo + floor(p·rsz/nbins), lo + ceil((p+1)·rsz/nbins)).  Exact integer
    arithmetic: a float quotient that is an ulp high annexes a whole extra
    feature cell at an exact-integer edge (e.g. 7·(9/7) → 9.000001)."""
    p = torch.arange(nbins, device=lo.device)
    start = (p * rsz[:, None]) // nbins + lo[:, None]
    end = ((p + 1) * rsz[:, None] + nbins - 1) // nbins + lo[:, None]
    s = torch.arange(src_size, device=lo.device)[None, :, None]
    return (s >= start[:, None, :]) & (s < end[:, None, :])


# RoIs are pooled in chunks whose first-stage temporary (RoIs × H × W × PW × C
# elements) stays under this size
POOL_CHUNK_ELEMS = 1 << 26


def _roi_pool_one(features: torch.Tensor, rois: torch.Tensor, out_hw,
                  spatial_scale: float) -> torch.Tensor:
    h, w, c = features.shape
    ph, pw = out_hw
    q = c_round(rois.float() * spatial_scale).to(torch.int64)  # (N, 4) corners
    my = _bin_mask(q[:, 1], (q[:, 3] - q[:, 1] + 1).clamp_min(1), h, ph)  # (N, H, PH)
    mx = _bin_mask(q[:, 0], (q[:, 2] - q[:, 0] + 1).clamp_min(1), w, pw)  # (N, W, PW)
    f = features.float()
    neg = torch.finfo(torch.float32).min
    step = max(1, POOL_CHUNK_ELEMS // (h * w * pw * c))
    outs = []
    for i in range(0, rois.shape[0], step):
        mxi, myi = mx[i:i + step], my[i:i + step]
        # max over w per x-bin: (n, H, PW, C); then over h per y-bin: (n, PH, PW, C)
        fx = torch.where(mxi[:, None, :, :, None], f[None, :, :, None, :], neg).amax(2)
        out = torch.where(myi.transpose(1, 2)[..., None, None], fx[:, None], neg).amax(2)
        outs.append(torch.where(out == neg, out.new_zeros(()), out))
    if not outs:
        return features.new_zeros((0, ph, pw, c))
    return torch.cat(outs).to(features.dtype)


def roi_pool(features: torch.Tensor, rois: torch.Tensor, out_hw: tuple[int, int] = (7, 7),
             spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Fast-RCNN quantized RoI max pooling with Caffe's semantics
    (``roi_pooling_layer.cpp``), the JAX package's ``roi_pool``.

    The RoI corners are rounded on the feature grid (:func:`c_round`); bin
    (p, q) covers the feature cells [floor(p·bh), ceil((p+1)·bh)) of the
    RoI, clipped to the map, and takes their max; an empty bin is 0.  The
    max is separable and masked, as in JAX: first over w within each
    x-bin, then over h within each y-bin, each stage a masked ``amax`` with
    a ``finfo(f32).min`` sentinel.  The backward goes to the features only,
    through autograd; ``amax`` splits a tie's gradient evenly among the tied
    cells, as JAX's ``max`` does, and keeping JAX's two stages makes an
    uneven pattern of ties split as it does there.

    Args:
      features: (H, W, C) map with (N, 4) ``rois``, or (B, H, W, C) maps
        with (B, N, 4) ``rois`` (x1, y1, x2, y2) in image coordinates.
      out_hw: (PH, PW).

    Returns (N, PH, PW, C) (or (B, N, PH, PW, C)) in the features' dtype.
    """
    if features.dim() == 3:
        return _roi_pool_one(features, rois, out_hw, spatial_scale)
    return torch.stack([_roi_pool_one(f, r, out_hw, spatial_scale)
                        for f, r in zip(features, rois)])
