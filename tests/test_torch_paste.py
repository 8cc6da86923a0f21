"""Port canvas paste (the plain twin of kernel C) and mask/box voting against
the JAX package.

The paste hats must match JAX's ``_paste_axis_weights`` to ≤1e-6 (argmin
edge clamp included).  The binarized canvases must equal
``paste_binarize_pallas`` (interpret mode) bit for bit, except pixels whose
f32 product lies within 1e-6 of the threshold (summation order differs).
Voting runs in f32 and must match JAX (``precision="highest"``) to ≤1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.mask_voting import box_voting_per_det as j_box_voting_per_det
from mnc_tpu.ops.mask_voting import mask_voting_per_det as j_mask_voting_per_det
from mnc_tpu.ops.masks import _paste_axis_weights as j_weights
from mnc_tpu.ops.masks import paste_masks as j_paste_masks
from mnc_tpu.ops.pallas.paste_kernel import paste_binarize_pallas
from mnc_tpu_torch.ops import mask_voting as mv
from mnc_tpu_torch.ops.masks import _paste_axis_weights, paste_masks

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
CANVAS = (96, 128)


def _dets(seed, n, m=21):
    rs = np.random.RandomState(seed)
    h, w = CANVAS
    x1 = rs.uniform(-10, w - 5, n)
    y1 = rs.uniform(-10, h - 5, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(4, 60, n), y1 + rs.uniform(4, 40, n)],
                     1).astype(np.float32)
    boxes[:4] = [[0, 0, 0, 0], [-50, -50, -20, -20], [200, 200, 400, 400],
                 [30, 20, 10, 5]]  # zero-area, outside, beyond, inverted
    masks = 1.0 / (1.0 + np.exp(-2.0 * rs.randn(n, m, m)))
    return masks.astype(np.float32), boxes


@pytest.mark.parametrize("m,out_len", [(21, 96), (9, 128), (28, 40)])
def test_paste_axis_weights_match_jax(m, out_len):
    _, boxes = _dets(m, 24)
    for lo, hi in ((1, 3), (0, 2)):
        want = np.asarray(j_weights(jnp.asarray(boxes[:, lo]), jnp.asarray(boxes[:, hi]),
                                    m, out_len))
        got = _paste_axis_weights(torch.from_numpy(boxes[:, lo]),
                                  torch.from_numpy(boxes[:, hi]), m, out_len)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _assert_canvas_match(got, want, prod, thresh, eps):
    mism = got != want
    assert np.abs(prod[mism] - thresh).max(initial=0.0) < eps
    assert mism.mean() < 1e-4


@pytest.mark.parametrize("seed,n,m", [(0, 16, 21), (1, 12, 28)])
def test_paste_matches_pallas_interpret(seed, n, m):
    masks, boxes = _dets(seed, n, m)
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), CANVAS, 0.4)
    assert got.dtype == torch.bool and got.shape == (n, *CANVAS)
    h, w = CANVAS
    jb = jnp.asarray(boxes)
    wy = j_weights(jb[:, 1], jb[:, 3], m, h)
    wx = j_weights(jb[:, 0], jb[:, 2], m, w)
    want = np.asarray(paste_binarize_pallas(wy, jnp.asarray(masks),
                                            jnp.swapaxes(wx, -1, -2), 0.4))
    prod = np.asarray(j_paste_masks(jnp.asarray(masks), jb, CANVAS, None))
    _assert_canvas_match(got.numpy(), want, prod, 0.4, 1e-6)
    assert not got[1:3].any()  # boxes outside the canvas paste nothing


def test_paste_batched_leading_dims():
    masks, boxes = _dets(2, 8)
    flat = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), CANVAS, 0.4)
    batched = paste_masks(torch.from_numpy(masks).reshape(2, 4, 21, 21),
                          torch.from_numpy(boxes).reshape(2, 4, 4), CANVAS, 0.4)
    np.testing.assert_array_equal(batched.reshape(8, *CANVAS).numpy(), flat.numpy())


def _vote_case(seed, n=6, cv=10, m=21):
    rs = np.random.RandomState(seed)
    kept = np.stack([rs.uniform(0, 50, n), rs.uniform(0, 40, n)], 1)
    kept = np.concatenate([kept, kept + rs.uniform(10, 40, (n, 2))], 1).astype(np.float32)
    cand = kept[:, None, :] + rs.uniform(-8, 8, (n, cv, 4)).astype(np.float32)
    scores = rs.uniform(size=(n, cv)).astype(np.float32)
    scores[:, -2:] = 0.0  # ignored entries
    masks = rs.uniform(size=(n, cv, m, m)).astype(np.float32)
    return kept, cand, scores, masks


def test_mask_voting_per_det_matches_jax():
    kept, cand, scores, masks = _vote_case(0)
    want = np.asarray(j_mask_voting_per_det(*map(jnp.asarray, (kept, cand, scores,
                                                                 masks)), 0.5))
    got = mv.mask_voting_per_det(*map(torch.from_numpy, (kept, cand, scores, masks)), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_box_voting_per_det_matches_jax():
    kept, cand, scores, _ = _vote_case(1)
    want = np.asarray(j_box_voting_per_det(*map(jnp.asarray, (kept, cand, scores)),
                                             0.5))
    got = mv.box_voting_per_det(*map(torch.from_numpy, (kept, cand, scores)), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_mask_voting_golden():
    g = np.load(os.path.join(GOLDEN, "mask_voting.npz"))
    n, k = len(g["kept"]), len(g["cand"])
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    merged = mv.mask_voting_per_det(
        t(g["kept"]), t(g["cand"]).expand(n, k, 4), t(g["scores"]).expand(n, k),
        t(g["masks"]).expand(n, k, *g["masks"].shape[1:]), 0.5)
    np.testing.assert_allclose(merged.numpy(), g["merged"], rtol=1e-4, atol=1e-5)
