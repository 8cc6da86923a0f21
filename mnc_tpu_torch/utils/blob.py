"""Image preprocessing — port of ``mnc_tpu/utils/blob.py``, with its own
bilinear resize in place of ``cv2``.

``prep_im_for_blob``: scale a BGR image so its shorter side hits SCALES[0]
with the longer side capped at MAX_SIZE (the reference rule), capped again
so it fits the static canvas, into which it is padded top-left.
``device_normalize`` subtracts the pixel means on the device.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``.  The machine
with the GPU has no ``cv2`` (nor PIL), so :func:`resize_linear` reproduces
cv2 5's arithmetic in torch, on whatever device the image lies:

- output size ``round(in·s)`` (half to even) for a factor, else the size
  given; source coordinate ``(d + 0.5)·(1/s) − 0.5``, taps clipped to the
  image;
- uint8: cv2's fixed point — 11-bit tap weights rounded from the f32
  fractions, the horizontal sum exact in int32, the vertical one as cv2's
  SIMD path computes it, ``((S0 >> 4)·β0 >> 16) + ((S1 >> 4)·β1 >> 16)``,
  then ``(· + 2) >> 2``; an exact 2× downscale is INTER_AREA, as cv2
  switches it (``(sum of 4 + 2) >> 2``, edge cells ``round(sum / count)``);
- float32: fractions taken in double and rounded to f32, and each pass a
  fused multiply-add ``fma(x1 − x0, f, x0)``, horizontal then vertical
  (emulated in float64: the product is exact there).

Held bit for bit against ``cv2`` by ``tests/test_torch_host_api.py`` (uint8
images of many sizes and scales, 0/1 and soft masks); 3-channel float
images agree to 2e-5.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mnc_tpu_torch.config import cfg

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _taps(n_in: int, n_out: int, scale: float, fixed_point: bool, device):
    """Per output index along one axis: the two source taps and the weight
    of the second (f32), as cv2 computes them.  ``fixed_point`` takes the
    fraction of the f32 coordinate (cv2's uint8 path); otherwise of the
    double one."""
    v = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    if fixed_point:
        v = v.astype(np.float32)
    s = np.floor(v)
    f = (v - s).astype(np.float32)
    s = s.astype(np.int64)
    i0 = torch.from_numpy(np.clip(s, 0, n_in - 1)).to(device)
    i1 = torch.from_numpy(np.clip(s + 1, 0, n_in - 1)).to(device)
    return i0, i1, s, f


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a·b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _resize_float(x: torch.Tensor, out_hw, scale_hw) -> torch.Tensor:
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    j0, j1, _, fy = _taps(h, oh, scale_hw[0], False, x.device)
    i0, i1, _, fx = _taps(w, ow, scale_hw[1], False, x.device)
    fx = torch.from_numpy(fx).to(x.device).view(1, 1, ow, 1)
    fy = torch.from_numpy(fy).to(x.device).view(1, oh, 1, 1)
    a = x.index_select(2, i0)
    t = _fma(x.index_select(2, i1) - a, fx, a)  # (N, H, OW, C)
    a = t.index_select(1, j0)
    return _fma(t.index_select(1, j1) - a, fy, a)


def _resize_u8(x: torch.Tensor, out_hw, scale_hw) -> torch.Tensor:
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    j0, j1, _, fy = _taps(h, oh, scale_hw[0], True, x.device)
    i0, i1, sx, fx = _taps(w, ow, scale_hw[1], True, x.device)
    # cv2 clamps the horizontal fraction at the borders (not the vertical)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)

    def weights(f, shape):
        w0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int32)
        w1 = np.rint(f * _COEF_SCALE).astype(np.int32)
        return (torch.from_numpy(w0).to(x.device).view(shape),
                torch.from_numpy(w1).to(x.device).view(shape))

    a0, a1 = weights(fx, (1, 1, ow, 1))
    b0, b1 = weights(fy, (1, oh, 1, 1))
    xi = x.to(torch.int32)
    t = xi.index_select(2, i0) * a0 + xi.index_select(2, i1) * a1  # exact, < 2^20
    out = (((t.index_select(1, j0) >> 4) * b0) >> 16) + (((t.index_select(1, j1) >> 4) * b1) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def _area2_u8(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2's INTER_AREA at an exact 2× downscale of uint8: full 2×2 cells
    ``(sum + 2) >> 2``, cells cut by the image edge ``round(sum / count)``."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    hh, ww = min(h, 2 * oh), min(w, 2 * ow)
    pad = (0, 0, 0, 2 * ow - ww, 0, 2 * oh - hh)
    s = torch.nn.functional.pad(x[:, :hh, :ww].to(torch.int32), pad)
    s = s.reshape(x.shape[0], oh, 2, ow, 2, x.shape[3]).sum((2, 4))
    ones = torch.ones(1, hh, ww, 1, dtype=torch.int32, device=x.device)
    cnt = torch.nn.functional.pad(ones, pad).reshape(1, oh, 2, ow, 2, 1).sum((2, 4))
    part = torch.round(s.float() / cnt.float()).to(torch.int32)
    return torch.where(cnt == 4, (s + 2) >> 2, part).to(torch.uint8)


def resize_linear(x: torch.Tensor, out_hw: tuple[int, int] | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """``cv2.resize(x, (W', H') or None, fx=scale, fy=scale,
    interpolation=cv2.INTER_LINEAR)`` on a (H, W) or (H, W, C) uint8 or
    float32 tensor, or a batch (N, H, W, C) of them, on its device.  Give
    ``out_hw`` or ``scale``."""
    lead = x.dim()
    if lead == 2:
        x = x[None, :, :, None]
    elif lead == 3:
        x = x[None]
    h, w = x.shape[1:3]
    if out_hw is None:
        out_hw = (int(round(h * scale)), int(round(w * scale)))
        inv = (scale, scale)
    else:
        inv = (out_hw[0] / h, out_hw[1] / w)
    scale_hw = (1.0 / inv[0], 1.0 / inv[1])
    if tuple(out_hw) == (h, w):
        out = x.clone()
    elif x.dtype == torch.uint8:
        area = all(abs(s - 2.0) < np.finfo(np.float64).eps for s in scale_hw)
        out = _area2_u8(x, out_hw) if area else _resize_u8(x, out_hw, scale_hw)
    else:
        out = _resize_float(x.float(), out_hw, scale_hw)
    if lead == 2:
        return out[0, :, :, 0]
    return out[0] if lead == 3 else out


def im_scale_for(shape_hw, target_size: int, max_size: int, canvas_hw) -> float:
    """The reference scale rule + canvas cap."""
    h, w = shape_hw
    short, long = min(h, w), max(h, w)
    scale = float(target_size) / short
    if round(scale * long) > max_size:
        scale = float(max_size) / long
    ch, cw = canvas_hw
    return min(scale, ch / h, cw / w)


def prep_im_for_blob(im, pixel_means=None, target_size: int | None = None,
                     max_size: int | None = None, canvas_hw=None, u8: bool = False,
                     device=None):
    """BGR (H, W, 3) uint8/float image (numpy or tensor) → (canvas, im_info).

    canvas (canvas_h, canvas_w, 3) is a tensor on ``device`` (default: the
    image's, the CPU for numpy): float32 mean-subtracted, or with ``u8``
    uint8 without the mean subtraction (``device_normalize`` does it after
    the upload) and padded with the rounded pixel means, so the padding
    becomes ~0 as in the float path.  Mean subtraction commutes with the
    linear resize, so the u8 path deviates from the float one by the
    ≤0.5-LSB rounding after the resize.  im_info = (scaled h, scaled w,
    scale) float32 numpy.  The image is uploaded before the resize, so only
    the original crosses to the device.
    """
    if pixel_means is None:
        pixel_means = cfg.PIXEL_MEANS
    if target_size is None:
        target_size = cfg.TEST.SCALES[0]
    if max_size is None:
        max_size = cfg.TEST.MAX_SIZE
    if canvas_hw is None:
        canvas_hw = tuple(cfg.STATIC.CANVAS)
    x = torch.as_tensor(np.ascontiguousarray(im) if isinstance(im, np.ndarray) else im)
    x = x.to(device) if device is not None else x
    means = np.asarray(pixel_means, np.float32).reshape(-1)
    if u8:
        x = x.to(torch.uint8)
    else:
        x = x.float() - torch.from_numpy(means).to(x.device)
    scale = im_scale_for(x.shape[:2], target_size, max_size, canvas_hw)
    scaled = resize_linear(x, scale=scale)
    ch, cw = canvas_hw
    sh, sw = min(scaled.shape[0], ch), min(scaled.shape[1], cw)
    if u8:
        fill = torch.from_numpy(np.round(means).astype(np.uint8)).to(x.device)
        canvas = fill.expand(ch, cw, 3).clone()
    else:
        canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=x.device)
    canvas[:sh, :sw] = scaled[:sh, :sw]
    return canvas, np.array([sh, sw, scale], np.float32)


def im_list_to_blob(ims) -> torch.Tensor:
    """Stack equal-shape canvases into a (B, H, W, 3) float32 batch."""
    return torch.stack([torch.as_tensor(i) for i in ims]).float()


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 canvases → mean-subtracted float32 on their device; float input
    passes through untouched, so the normalization is idempotent."""
    if images.dtype == torch.uint8:
        means = torch.as_tensor(np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(-1),
                                device=images.device)
        return images.float() - means
    return images


def _area_matrix(n_in: int, n_out: int, true_area: bool) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_AREA along one axis: the share of
    each source cell under the output cell (``true_area``), else cv2's
    area-mode bilinear taps."""
    inv = n_out / n_in
    scale = 1.0 / inv
    m = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        if true_area:
            f1, f2 = d * scale, d * scale + scale
            s1, s2 = math.ceil(f1), math.floor(f2)
            cell = min(scale, n_in - f1)
            if s1 - f1 > 1e-3:
                m[d, s1 - 1] = (s1 - f1) / cell
            m[d, s1:min(s2, n_in)] = 1.0 / cell
            if f2 - s2 > 1e-3 and s2 < n_in:
                m[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
            continue
        s = math.floor(d * scale)
        f = (d + 1) - (s + 1) * inv
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s >= n_in - 1:
            s, f = n_in - 1, 0.0
        m[d, s] += 1.0 - f
        m[d, min(s + 1, n_in - 1)] += f
    return m


def resize_mask_area(mask, out_hw) -> np.ndarray:
    """Mask resize as ``cv2.resize(mask, (W', H'), interpolation=INTER_AREA)``
    (float32 numpy out): area-weighted means when both axes shrink, else
    cv2's area-mode bilinear on both; to f32 rounding of cv2's sums."""
    m = np.asarray(mask, np.float64)
    (h, w), (oh, ow) = m.shape, out_hw
    true_area = oh <= h and ow <= w
    return (_area_matrix(h, oh, true_area) @ m
            @ _area_matrix(w, ow, true_area).T).astype(np.float32)
