"""The port's RoI-warp gradient (autograd through ``roi_warp_plain``, the plain
twin of kernels A and A′) against ``jax.vjp`` of the JAX package's
``roi_warp`` (einsum, and the Pallas kernel in interpret mode, whose VJP
delegates to the einsum), for the features AND the box coordinates, plus a
finite-difference check.

Tolerances: f32 on both sides: rtol 1e-5 of each gradient's max.  The bf16
case compares the two packages' bf16 paths, which round the hats and the
x-pass intermediate alike, at 2^-6 of the max.  Finite differences (f64 not
available in the hat path, so f32 with a 1e-2 px step): 5% as the JAX
package's own check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.roi_warp import roi_warp as j_roi_warp
from mnc_tpu_torch.ops.roi_warp import RoIWarpFunction, roi_warp, roi_warp_plain
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

H, W, C = 12, 16, 8
SCALE = 1.0 / 4.0  # image 48x64 -> feature 12x16


def _inputs(seed, n=7, out_hw=(5, 5)):
    rs = np.random.RandomState(seed)
    feat = rs.randn(H, W, C).astype(np.float32)
    xy = rs.uniform(-6, [4 * W - 10, 4 * H - 10], size=(n, 2))
    wh = rs.uniform(6, 40, size=(n, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)  # some cross the border
    cot = rs.randn(n, *out_hw, C).astype(np.float32)
    return feat, rois, cot


def _torch_grads(feat, rois, cot, out_hw, dtype=torch.float32):
    f = torch.tensor(feat).to(dtype).requires_grad_()
    r = torch.tensor(rois, requires_grad=True)
    out = roi_warp(f, r, out_hw, SCALE)
    out.backward(torch.tensor(cot).to(dtype))
    return out.detach().float().numpy(), f.grad.float().numpy(), r.grad.numpy()


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
@pytest.mark.parametrize("out_hw", [(5, 5), (7, 3)])
def test_grads_match_jax_f32(impl, out_hw):
    feat, rois, cot = _inputs(0, out_hw=out_hw)
    want, vjp = jax.vjp(lambda f, r: j_roi_warp(f, r, out_hw, SCALE, impl=impl),
                        jnp.asarray(feat), jnp.asarray(rois))
    wf, wr = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    out, gf, gr = _torch_grads(feat, rois, cot, out_hw)
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-5 * np.abs(wf).max())
    np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-5 * np.abs(wr).max())
    assert np.abs(wr).max() > 0  # the gradient to the boxes is live


def test_grads_match_jax_bf16():
    feat, rois, cot = _inputs(1)
    f16 = jnp.asarray(feat, jnp.bfloat16)
    _, vjp = jax.vjp(lambda f, r: j_roi_warp(f, r, (5, 5), SCALE), f16, jnp.asarray(rois))
    wf, wr = vjp(jnp.asarray(cot, jnp.bfloat16))
    wf, wr = np.asarray(wf.astype(jnp.float32)), np.asarray(wr)
    _, gf, gr = _torch_grads(feat, rois, cot, (5, 5), torch.bfloat16)
    np.testing.assert_allclose(gf, wf, rtol=0, atol=2.0 ** -6 * np.abs(wf).max())
    np.testing.assert_allclose(gr, wr, rtol=0, atol=2.0 ** -6 * np.abs(wr).max())


def test_integer_coordinates_and_map_edge_follow_the_hat_form():
    """A box whose bin centers are integers, one hanging over the map's
    edge: the derivative is JAX's (half of each neighbour's at the hat's
    zero, nothing from taps outside the map), not grid_sample's."""
    rs = np.random.RandomState(2)
    feat = rs.randn(H, W, C).astype(np.float32)
    # span 4 cells from a cell corner with 4 bins -> centers at integers
    rois = np.array([[8.0, 4.0, 23.0, 19.0], [-4.0, 36.0, 11.0, 51.0],
                     [52.0, 8.0, 67.0, 23.0]], np.float32)
    cot = rs.randn(3, 4, 4, C).astype(np.float32)
    _, vjp = jax.vjp(lambda f, r: j_roi_warp(f, r, (4, 4), SCALE), jnp.asarray(feat),
                     jnp.asarray(rois))
    wf, wr = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    _, gf, gr = _torch_grads(feat, rois, cot, (4, 4))
    np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-5 * np.abs(wf).max())
    np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-5 * np.abs(wr).max())


def test_finite_differences():
    feat, rois, cot = _inputs(3, n=4)
    rois = rois + 0.13  # off the hat's kinks
    _, gf, gr = _torch_grads(feat, rois, cot, (5, 5))

    def loss(f, r):
        out = roi_warp_plain(torch.tensor(f)[None], torch.tensor(r)[None], (5, 5), SCALE)
        return float((out[0].double() * torch.tensor(cot).double()).sum())

    rs = np.random.RandomState(4)
    eps = 1e-2
    for _ in range(12):
        i, j = rs.randint(len(rois)), rs.randint(4)
        hi, lo = rois.copy(), rois.copy()
        hi[i, j] += eps
        lo[i, j] -= eps
        fd = (loss(feat, hi) - loss(feat, lo)) / (2 * eps)
        np.testing.assert_allclose(gr[i, j], fd, rtol=5e-2, atol=5e-2)
    for _ in range(6):
        idx = tuple(rs.randint(s) for s in feat.shape)
        hi, lo = feat.copy(), feat.copy()
        hi[idx] += 0.5
        lo[idx] -= 0.5
        np.testing.assert_allclose(gf[idx], loss(hi, rois) - loss(lo, rois), rtol=1e-3,
                                   atol=1e-3)


def test_batched_grads_equal_per_image_grads():
    f0, r0, c0 = _inputs(5)
    f1, r1, c1 = _inputs(6)
    f = torch.tensor(np.stack([f0, f1]), requires_grad=True)
    r = torch.tensor(np.stack([r0, r1]), requires_grad=True)
    roi_warp(f, r, (5, 5), SCALE).backward(torch.tensor(np.stack([c0, c1])))
    for i, (fi, ri, ci) in enumerate(((f0, r0, c0), (f1, r1, c1))):
        _, gf, gr = _torch_grads(fi, ri, ci, (5, 5))
        np.testing.assert_allclose(f.grad[i].numpy(), gf, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.grad[i].numpy(), gr, rtol=1e-6, atol=1e-6)


def test_function_refuses_cpu_tensors():
    """The autograd Function is the card's route: it launches kernels or
    raises; CPU tensors never reach it through ``roi_warp``."""
    f = torch.zeros(1, 4, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RoIWarpFunction.apply(f, torch.zeros(1, 2, 4), (2, 2), 0.25)


# ---- kernel A′'s algorithm, step by step on the CPU -------------------------

_f = np.float32


def _axis_taps(lo, hi, bins, size, scale):
    """``csrc/roi_warp_bwd.cu`` axis_taps for every bin of one axis: per bin
    the tap indices (floor - 1, floor, floor + 1), hat weights and hat
    derivatives (0 outside the map), in the kernel's f32 operation order."""
    taps = []
    for i in range(bins):
        grid = _f(_f(i) + _f(0.5)) / _f(bins)
        span = _f(_f(_f(hi - lo) + _f(1.0)) * _f(scale))
        c = _f(_f(_f(lo * _f(scale)) + _f(grid * span)) - _f(0.5))
        reach = bool(c > -2.0) and bool(c < size + 1.0)  # False for NaN too
        fl = np.floor(c) if reach else _f(0.0)
        idx, w, d = [], [], []
        for k in range(3):
            h = int(fl) - 1 + k
            diff = _f(c - _f(fl + _f(k - 1)))
            v = _f(_f(1.0) - abs(diff))
            inside = reach and 0 <= h < size
            sgn = 1.0 if diff >= 0 else -1.0
            idx.append(h if inside else 0)
            w.append(float(v) if inside and v > 0 else 0.0)
            d.append(0.0 if not inside else (-sgn if v > 0 else (-0.5 * sgn if v == 0 else 0.0)))
        taps.append((idx, w, d, float(grid)))
    return taps


def footprint_model(feat, rois, cot, out_hw, scale):
    """Model of kernel A′ for one map: d rois from the three taps per axis
    (its d rois items), dF by map tile in the kernel's order (the tile lists
    and splits of ``kernels.roi_warp_bwd_lists`` / ``roi_warp_bwd_plan``;
    ``tests/test_torch_train_determinism.py::tile_gather_dfeat``).  Returns
    (dF, d rois, tiles): tiles[n] is how many tile lists hold RoI n."""
    from mnc_tpu_torch.kernels import roi_warp_bwd_lists
    from tests.test_torch_train_determinism import tile_gather_dfeat

    h, w, _ = feat.shape
    drois = np.zeros((len(rois), 4))
    for n, (x1, y1, x2, y2) in enumerate(rois.astype(np.float32)):
        ty = _axis_taps(y1, y2, out_hw[0], h, scale)
        tx = _axis_taps(x1, x2, out_hw[1], w, scale)
        g = cot[n].astype(np.float64)
        for p, (iy, wy, dy, gy) in enumerate(ty):
            for q, (ix, wx, dx, gx) in enumerate(tx):
                dyc = dxc = 0.0
                for ky in range(3):
                    for kx in range(3):
                        if dy[ky] * wx[kx] == 0.0 and wy[ky] * dx[kx] == 0.0:
                            continue
                        dot = float(g[p, q] @ feat[iy[ky], ix[kx]].astype(np.float64))
                        dyc += dy[ky] * wx[kx] * dot
                        dxc += wy[ky] * dx[kx] * dot
                drois[n] += scale * np.array([dxc * (1 - gx), dyc * (1 - gy), dxc * gx, dyc * gy])
    r = torch.tensor(rois)[None]
    dfeat = tile_gather_dfeat(torch.tensor(cot)[None], r, out_hw, scale, (h, w))[0].numpy()
    _, lists = roi_warp_bwd_lists(r, out_hw, scale, (h, w))
    tiles = [int((lists[0] == n).sum()) for n in range(len(rois))]
    return dfeat, drois, tiles


_BOXES = {  # on a 48 x 64 image (12 x 16 cells at scale 1/4)
    "one_px": [[20.0, 17.0, 20.0, 17.0], [0.0, 0.0, 0.0, 0.0]],
    "eight_cells": [[9.3, 6.1, 40.9, 37.7], [13.0, 2.5, 44.0, 33.9]],
    "full_canvas": [[0.0, 0.0, 63.0, 47.0]],
    "partly_outside": [[-9.0, -7.5, 14.0, 11.0], [50.5, 30.0, 80.0, 66.0],
                       [-30.0, 10.0, 90.0, 13.0]],
    "wholly_outside": [[-60.0, -60.0, -30.0, -30.0], [100.0, 5.0, 130.0, 25.0]],
    "integer_aligned": [[8.0, 4.0, 23.0, 19.0], [-4.0, 36.0, 11.0, 51.0], [52.0, 8.0, 67.0, 23.0]],
}


@pytest.mark.parametrize("out_hw", [(4, 4), (7, 5), (14, 14)])
@pytest.mark.parametrize("kind", sorted(_BOXES))
def test_footprint_model_matches_autograd_and_jax(kind, out_hw):
    """Kernel A′'s form (d rois from three taps per axis, dF gathered by map
    tile in list order) gives the plain version's gradients (autograd) and
    the JAX package's (``jax.vjp``): dF within 1e-5 of its max, d rois
    within 1e-4 of its max, in f32."""
    rs = np.random.RandomState(len(kind) + out_hw[0])
    feat = rs.randn(H, W, C).astype(np.float32)
    rois = np.array(_BOXES[kind], np.float32)
    if kind == "integer_aligned" and out_hw != (4, 4):
        # span out_hw cells from a cell corner, so that bin centers are integers
        rois[:, 2] = rois[:, 0] + 4 * out_hw[1] - 1
        rois[:, 3] = rois[:, 1] + 4 * out_hw[0] - 1
    cot = rs.randn(len(rois), *out_hw, C).astype(np.float32)
    gf, gr, tiles = footprint_model(feat, rois, cot, out_hw, SCALE)
    _, tf, tr = _torch_grads(feat, rois, cot, out_hw)
    _, vjp = jax.vjp(lambda f, r: j_roi_warp(f, r, out_hw, SCALE), jnp.asarray(feat),
                     jnp.asarray(rois))
    jf, jr = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    for wf, wr in ((tf, tr), (jf, jr)):
        np.testing.assert_allclose(gf, wf, rtol=0, atol=max(1e-5 * np.abs(wf).max(), 1e-30))
        np.testing.assert_allclose(gr, wr, rtol=0, atol=max(1e-4 * np.abs(wr).max(), 1e-30))
    # a RoI is listed by the tiles its footprint reaches: a 1-px box's 3 x 3
    # taps by at most 2 x 2 tiles, a box wholly outside by none
    if kind == "one_px":
        assert all(1 <= t <= 4 for t in tiles)
    if kind == "wholly_outside":
        assert tiles == [0, 0] and not gf.any() and not gr.any()


def test_footprint_model_non_monotone_rows():
    """A box with y2 < y1 - 1 has bin centers that move UP the map: its tile
    lists bound the rows by the smaller and the larger end center, the bins
    that reach a row are still one run, and dF still sums to the plain
    gradient."""
    rs = np.random.RandomState(11)
    feat = rs.randn(H, W, C).astype(np.float32)
    rois = np.array([[10.0, 40.0, 40.0, 8.0]], np.float32)
    cot = rs.randn(1, 7, 5, C).astype(np.float32)
    gf, gr, _ = footprint_model(feat, rois, cot, (7, 5), SCALE)
    _, tf, tr = _torch_grads(feat, rois, cot, (7, 5))
    np.testing.assert_allclose(gf, tf, rtol=0, atol=1e-5 * np.abs(tf).max())
    np.testing.assert_allclose(gr, tr, rtol=0, atol=1e-4 * np.abs(tr).max())
