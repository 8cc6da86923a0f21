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
JAX package's hat-matrix einsum, differentiated by autograd.  ``roi_pool``
is not ported yet.
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


class RoIWarpFunction(torch.autograd.Function):
    """Kernel A forward, kernel A′ backward (CUDA tensors only).

    The gradient to the features is summed per RoI in registers and added
    to an f32 map with one atomic per cell the RoI touches, so its last bits
    vary from run to run; the gradient to the rois is deterministic.
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
    if features.is_cuda:
        features, rois = features.contiguous(), rois.float().contiguous()
        if torch.is_grad_enabled() and (features.requires_grad or rois.requires_grad):
            out = RoIWarpFunction.apply(features, rois, tuple(out_hw), spatial_scale)
        else:
            from mnc_tpu_torch.kernels import roi_warp_cuda

            out = roi_warp_cuda(features, rois, out_hw, spatial_scale)
    else:
        out = roi_warp_plain(features, rois.float(), out_hw, spatial_scale)
    return out[0] if single else out
