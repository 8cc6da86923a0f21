"""Port NMS (the plain twin of kernel B) against the JAX package.

Keep masks and selected indices must be IDENTICAL to JAX's ``nms_fixed``,
``nms_tiled`` (with a chunk smaller than K), ``nms_pallas`` (interpret mode)
and ``nms_indices``, and to the golden fixture — including exact score ties
(broken by lower index) and invalid padding.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops import nms as jnms
from mnc_tpu_torch.ops import nms
from tests.conftest import random_boxes

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _case(seed, k, tie_levels=None, invalid=0.1):
    rs = np.random.RandomState(seed)
    boxes = np.stack([rs.uniform(0, 300, k), rs.uniform(0, 200, k),
                      np.zeros(k), np.zeros(k)], 1).astype(np.float32)
    boxes[:, 2] = boxes[:, 0] + rs.uniform(4, 90, k)
    boxes[:, 3] = boxes[:, 1] + rs.uniform(4, 90, k)
    scores = rs.uniform(size=k).astype(np.float32)
    if tie_levels:  # quantize → many exact ties
        scores = np.round(scores * tie_levels).astype(np.float32) / tie_levels
    valid = rs.uniform(size=k) > invalid
    return boxes, scores, valid


def _sorted(boxes, scores, valid):
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    return boxes[order], valid[order]


@pytest.mark.parametrize("seed,k,thresh", [(0, 64, 0.3), (1, 200, 0.5), (2, 300, 0.7),
                                           (3, 17, 0.5)])
def test_nms_fixed_matches_jax(seed, k, thresh):
    boxes, valid = _sorted(*_case(seed, k))
    want = np.asarray(jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(valid), thresh))
    got = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,k,chunk,top_n,thresh", [
    (4, 700, 128, 100, 0.7),
    (5, 1000, 256, 30, 0.5),   # the top_n buffer fills early
    (6, 500, 64, 304, 0.3),    # fewer keeps than top_n
])
def test_nms_tiled_matches_jax(seed, k, chunk, top_n, thresh):
    boxes, valid = _sorted(*_case(seed, k))
    want = np.asarray(jnms.nms_tiled(jnp.asarray(boxes), jnp.asarray(valid), thresh,
                                     top_n, chunk))
    got = nms.nms_tiled(torch.from_numpy(boxes), torch.from_numpy(valid), thresh,
                        top_n).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() <= top_n


@pytest.mark.parametrize("seed,k,thresh", [(7, 64, 0.5), (8, 48, 0.3)])
def test_nms_fixed_matches_pallas_interpret(seed, k, thresh):
    from mnc_tpu.ops.pallas.nms_kernel import nms_pallas

    boxes, valid = _sorted(*_case(seed, k))
    want = np.asarray(nms_pallas(jnp.asarray(boxes), jnp.asarray(valid), thresh))
    got = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,top_n,chunk,presorted,ties", [
    (64, 16, None, False, 8),
    (300, 32, 64, False, 20),
    (300, 300, None, False, 4),    # top_n == K: padding points at idx[0]
    (256, 40, 64, True, 10),
])
def test_nms_indices_matches_jax_with_ties(k, top_n, chunk, presorted, ties):
    boxes, scores, valid = _case(k + top_n, k, tie_levels=ties, invalid=0.3)
    if presorted:  # descending scores, invalid trailing (the propose_rois path)
        masked = np.where(valid, scores, np.finfo(np.float32).min)
        order = np.argsort(-masked, kind="stable")
        boxes, scores, valid = boxes[order], masked[order], valid[order]
    want = jnms.nms_indices(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                            0.5, top_n, chunk=chunk, presorted=presorted)
    got = nms.nms_indices(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), 0.5, top_n, chunk=chunk,
                          presorted=presorted)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_nms_indices_batched_equals_per_problem():
    """Leading dims are independent problems (one kernel launch serves them
    all on the GPU)."""
    cases = [_case(s, 120, tie_levels=12, invalid=0.2) for s in range(6)]
    b = torch.from_numpy(np.stack([c[0] for c in cases])).reshape(2, 3, 120, 4)
    s = torch.from_numpy(np.stack([c[1] for c in cases])).reshape(2, 3, 120)
    v = torch.from_numpy(np.stack([c[2] for c in cases])).reshape(2, 3, 120)
    idx, kv = nms.nms_indices(b, s, v, 0.3, 10)
    assert idx.shape == kv.shape == (2, 3, 10)
    for i, (bx, sc, va) in enumerate(cases):
        want = jnms.nms_indices(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(va), 0.3, 10)
        np.testing.assert_array_equal(idx.reshape(6, 10)[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(kv.reshape(6, 10)[i].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("chunk", [None, 16])
def test_nms_golden(thresh, chunk):
    g = np.load(os.path.join(GOLDEN, "nms.npz"))
    n = len(g["boxes"])
    idx, kv = nms.nms_indices(torch.as_tensor(g["boxes"], dtype=torch.float32),
                              torch.as_tensor(g["scores"], dtype=torch.float32),
                              torch.ones(n, dtype=torch.bool), thresh, top_n=n,
                              chunk=chunk)
    np.testing.assert_array_equal(idx[kv].numpy(), g[f"keep_{int(thresh * 10)}"])


def test_nms_threshold_compares_in_f32():
    """IoU exactly at the f32 threshold does not suppress (JAX compares a
    weak-typed threshold in f32)."""
    # two 10x10 boxes overlapping in 3x10 px: IoU = 30/170, rounded to f32
    boxes = np.array([[0, 0, 9, 9], [7, 0, 16, 9]], np.float32)
    iou = float(np.float32(30.0) / np.float32(170.0))
    valid = np.ones(2, bool)
    for thresh in (iou, np.nextafter(np.float32(iou), np.float32(0))):
        want = np.asarray(jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(valid),
                                         float(thresh)))
        got = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(valid),
                            float(thresh)).numpy()
        np.testing.assert_array_equal(got, want)


def test_random_boxes_keep_count_matches_jax(rng):
    boxes = random_boxes(rng, 400, h=300.0, w=500.0)
    valid = np.ones(400, bool)
    want = np.asarray(jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(valid), 0.7))
    got = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(valid), 0.7).numpy()
    np.testing.assert_array_equal(got, want)
