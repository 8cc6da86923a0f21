"""RoI warping (forward) — port of ``mnc_tpu/ops/roi_warp.py``.

Bilinear crop-and-resize of RoIs from NHWC feature maps, the forward of the
reference ``roi_warping_layer``.  Sampling convention (Caffe-compatible):
pixel centers at integer coordinates, RoI width with the +1 convention, and
bin (p, q) of RoI (x1, y1, x2, y2) samples at

    yc = y1*s + (p + 0.5) * (y2 - y1 + 1) * s / PH - 0.5
    xc = x1*s + (q + 0.5) * (x2 - x1 + 1) * s / PW - 0.5

with zero contribution outside the feature map.  A CUDA tensor goes to
kernel A (``csrc/roi_warp.cu``, a direct 4-tap gather); a CPU tensor goes to
:func:`roi_warp_plain`, the JAX package's hat-matrix einsum.  The backward
pass and ``roi_pool`` are not ported yet (training).
"""

from __future__ import annotations

import torch


def bin_centers(rois: torch.Tensor, out_size: int, spatial_scale: float, axis: int):
    """(..., N, 4) image-coordinate rois → (..., N, P) f32 feature-space
    coords of the bin centers along one axis (0 = y, 1 = x)."""
    lo = rois[..., 1] if axis == 0 else rois[..., 0]
    hi = rois[..., 3] if axis == 0 else rois[..., 2]
    span = (hi - lo + 1.0) * spatial_scale
    grid = (torch.arange(out_size, dtype=torch.float32, device=rois.device) + 0.5) / out_size
    return lo.unsqueeze(-1) * spatial_scale + grid * span.unsqueeze(-1) - 0.5


def interp_matrix(centers: torch.Tensor, src_size: int) -> torch.Tensor:
    """Hat-function interpolation weights (..., P, S) for coords (..., P)."""
    src = torch.arange(src_size, dtype=torch.float32, device=centers.device)
    return (1.0 - (centers.unsqueeze(-1) - src).abs()).clamp_min(0.0)


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

    Returns (B, N, PH, PW, C) in the feature dtype (no batch dim for one map).
    """
    single = features.dim() == 3
    if single:
        features, rois = features.unsqueeze(0), rois.unsqueeze(0)
    if features.is_cuda:
        from mnc_tpu_torch.kernels import roi_warp_cuda

        out = roi_warp_cuda(features.contiguous(), rois.float().contiguous(),
                            out_hw, spatial_scale)
    else:
        out = roi_warp_plain(features, rois.float(), out_hw, spatial_scale)
    return out[0] if single else out
