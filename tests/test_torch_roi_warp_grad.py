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
