"""Port RoI warp (the plain twin of kernel A) against the JAX package.

In f32 the port must match ``roi_warp_pallas`` (interpret mode) and
``_warp_einsum`` to ≤1e-5·max|F| (the same linear map; only summation order
differs).  In bf16 both packages round the hats and the x-pass intermediate
to bf16, so the port must match JAX's bf16 einsum to within 2 bf16 ulps of
the output scale (2·2⁻⁸·max|F|: the rounded intermediates may straddle a
rounding boundary differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.pallas.roi_warp_kernel import roi_warp_pallas
from mnc_tpu.ops.roi_warp import _warp_einsum, bin_centers as j_bin_centers
from mnc_tpu.ops.roi_warp import interp_matrix as j_interp_matrix
from mnc_tpu_torch.ops.roi_warp import bin_centers, interp_matrix, roi_warp, roi_warp_plain
from tests.conftest import random_boxes
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

H, W, C = 12, 16, 8
SCALE = 1.0 / 4.0  # image 48x64 -> feature 12x16


def _inputs(seed, n=6, b=1):
    rs = np.random.RandomState(seed)
    feat = rs.randn(b, H, W, C).astype(np.float32)
    rois = np.stack([random_boxes(rs, n, h=4 * H, w=4 * W, min_size=6.0)
                     for _ in range(b)])
    # RoIs hanging off every edge: samples outside the map weigh zero
    rois[:, 0] = [-20.0, -12.0, 30.0, 70.0]
    rois[:, 1] = [40.0, 50.0, 80.0, 60.0]
    return feat, rois


@pytest.mark.parametrize("out_hw", [(7, 7), (4, 5)])
def test_plain_matches_pallas_interpret_and_einsum_f32(out_hw):
    feat, rois = _inputs(0)
    got = roi_warp(torch.from_numpy(feat[0]), torch.from_numpy(rois[0]), out_hw,
                   SCALE).numpy()
    tol = 1e-5 * np.abs(feat).max()
    pallas = np.asarray(roi_warp_pallas(jnp.asarray(feat[0]), jnp.asarray(rois[0]),
                                        out_hw, SCALE))
    einsum = np.asarray(_warp_einsum(jnp.asarray(feat[0]), jnp.asarray(rois[0]),
                                     out_hw, SCALE))
    assert got.shape == (6, *out_hw, C)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    np.testing.assert_allclose(got, einsum, rtol=0, atol=tol)


def test_plain_matches_einsum_bf16():
    feat, rois = _inputs(1, n=10)
    fb = torch.from_numpy(feat[0]).to(torch.bfloat16)
    got = roi_warp(fb, torch.from_numpy(rois[0]), (7, 7), SCALE)
    assert got.dtype == torch.bfloat16
    want = _warp_einsum(jnp.asarray(fb.float().numpy(), jnp.bfloat16),
                        jnp.asarray(rois[0]), (7, 7), SCALE)
    tol = 2 * 2.0 ** -8 * float(fb.float().abs().max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def test_batched_equals_per_image():
    feat, rois = _inputs(2, n=5, b=3)
    out = roi_warp_plain(torch.from_numpy(feat), torch.from_numpy(rois), (7, 7), SCALE)
    assert out.shape == (3, 5, 7, 7, C)
    for i in range(3):
        want = np.asarray(_warp_einsum(jnp.asarray(feat[i]), jnp.asarray(rois[i]),
                                       (7, 7), SCALE))
        np.testing.assert_allclose(out[i].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(feat).max())


def test_bin_centers_and_hats_match_jax():
    _, rois = _inputs(3, n=9)
    for axis, size in ((0, H), (1, W)):
        want_c = np.asarray(j_bin_centers(jnp.asarray(rois[0]), 14, SCALE, axis))
        got_c = bin_centers(torch.from_numpy(rois[0]), 14, SCALE, axis)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        want_h = np.asarray(j_interp_matrix(jnp.asarray(want_c), size))
        np.testing.assert_array_equal(interp_matrix(got_c, size).numpy(), want_h)


def test_constant_map_is_constant_inside():
    """A constant map warps to the constant wherever all taps are inside."""
    feat = torch.full((1, H, W, C), 3.0)
    rois = torch.tensor([[[8.0, 8.0, 40.0, 30.0]]])
    out = roi_warp(feat, rois, (5, 5), SCALE)
    np.testing.assert_allclose(out.numpy(), 3.0, rtol=1e-6)
