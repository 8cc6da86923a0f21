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
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

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


# ---- kernel B's algorithm, step by step on the CPU --------------------------

def chunked_scan_model(boxes, valid, thresh, top_n=0, cluster=1):
    """Model of ``csrc/nms.cu``: 64-bit words (Python ints), one dependent step
    per chunk of 64 candidates.  Returns (keep, rounds): the keep mask and the
    most fixpoint rounds any chunk's diagonal resolution took.

    Per chunk: (1) pull — every block of the cluster ORs "a keep of my share
    suppresses candidate t" into a word, the words are ORed; (2) the diagonal
    tile as column words (bit i of col[t]: valid i < t suppresses t); (4) keep
    = alive & no kept earlier box of the chunk suppresses, iterated from keep
    = alive until it stands still; the ``top_n`` count cuts the word after the
    last wanted keep; (5) the keeps join the list, dealt over the cluster.
    """
    from mnc_tpu_torch.ops.bbox import bbox_overlaps

    k = len(boxes)
    tb = torch.from_numpy(np.ascontiguousarray(boxes))
    sup = (bbox_overlaps(tb, tb) > float(np.float32(thresh))).numpy()
    popcount = lambda x: bin(x).count("1")  # noqa: E731
    keep = np.zeros(k, bool)
    kept = []
    rounds = 0
    for c in range(-(-k // 64)):
        lo, n = 64 * c, min(64, k - 64 * c)
        valid_word = sum(1 << t for t in range(n) if valid[lo + t])
        removed = 0
        for rank in range(cluster):
            word = 0
            for i in kept[rank::cluster]:
                word |= sum(1 << t for t in range(n) if sup[i, lo + t])
            removed |= word
        col = [sum(1 << i for i in range(t) if (valid_word >> i) & 1 and sup[lo + i, lo + t])
               for t in range(n)]
        alive = valid_word & ~removed
        kw, r = alive, 0
        while True:
            r += 1
            nw = alive & ~sum(1 << t for t in range(n) if col[t] & kw)
            if nw == kw:
                break
            kw = nw
        rounds = max(rounds, r)
        done = False
        if top_n > 0 and len(kept) + popcount(kw) >= top_n:
            need = top_n - len(kept)
            kw = sum(1 << t for t in range(n)
                     if (kw >> t) & 1 and popcount(kw & ((1 << t) - 1)) < need)
            done = True
        for t in range(n):
            if (kw >> t) & 1:
                keep[lo + t] = True
                kept.append(lo + t)
        if done:
            break
    return keep, rounds


def _hold_model(boxes, valid, thresh, top_n, cluster=1):
    """The model against the plain twin and the JAX package; returns keep."""
    got, _ = chunked_scan_model(boxes, valid, thresh, top_n, cluster)
    plain = nms.nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                               thresh, top_n)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    jb, jv = jnp.asarray(boxes), jnp.asarray(valid)
    if top_n > 0:
        want = np.asarray(jnms.nms_tiled(jb, jv, thresh, top_n, 32))
    else:
        want = np.asarray(jnms.nms_fixed(jb, jv, thresh))
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("k", [63, 64, 65, 129, 304])
@pytest.mark.parametrize("layout", ["interleaved", "trailing"])
def test_chunked_scan_model_matches_plain_and_jax(k, layout):
    """K around the 64-bit word borders, exact score ties, invalid boxes
    interleaved (the per-class layout) and trailing (the proposal layout),
    the scan run to its end and stopped, one block and a cluster of 8."""
    boxes, scores, valid = _case(100 + k, k, tie_levels=8, invalid=0.25)
    if layout == "trailing":
        valid = np.arange(k) < int(0.75 * k)
    boxes, valid = _sorted(boxes, scores, valid)
    for thresh in (0.3, 0.7):
        full = _hold_model(boxes, valid, thresh, 0)
        for top_n in (1, max(int(full.sum()) // 2, 1), int(full.sum()), int(full.sum()) + 5):
            for cluster in (1, 8):
                got = _hold_model(boxes, valid, thresh, top_n, cluster)
                assert got.sum() == min(top_n, full.sum())


@pytest.mark.parametrize("stop_at", [0, 63, 64, 100, 127, 128])
def test_chunked_scan_model_stop_inside_a_chunk(stop_at):
    """The top_n-th keep falls on the first, a middle and the last box of a
    chunk: exactly the first top_n keeps, none of the next."""
    boxes, scores, valid = _case(7, 200, invalid=0.0)
    boxes, valid = _sorted(boxes, scores, valid)
    # the boxes at the stops and right after them stand alone, so they are keeps
    for i in (0, 1, 63, 64, 65, 100, 101, 127, 128, 129):
        boxes[i] = [5000.0 + 200 * i, 5000.0, 5100.0 + 200 * i, 5100.0]
    full = _hold_model(boxes, valid, 0.5, 0)
    assert full[stop_at] and full[stop_at + 1]
    top_n = int(full[:stop_at + 1].sum())
    for cluster in (1, 8):
        got = _hold_model(boxes, valid, 0.5, top_n, cluster)
        assert got[stop_at] and not got[stop_at + 1:].any() and got.sum() == top_n


@pytest.mark.parametrize("k", [129, 200])
def test_chunked_scan_model_chain_across_chunks(k):
    """Box i suppresses only box i + 1 (IoU 81/121 against 61/141 two apart):
    keeps alternate along the whole length, across the chunk borders, and the
    diagonal resolution needs as many rounds as the chunk is long."""
    x = 20.0 * np.arange(k, dtype=np.float32)
    boxes = np.stack([x, np.zeros_like(x), x + 100.0, np.full_like(x, 100.0)], 1)
    valid = np.ones(k, bool)
    got = _hold_model(boxes, valid, 0.5, 0)
    np.testing.assert_array_equal(got, np.arange(k) % 2 == 0)
    assert chunked_scan_model(boxes, valid, 0.5)[1] >= 63
    # an invalid box breaks the chain: its successor is kept too
    valid[64] = False
    got = _hold_model(boxes, valid, 0.5, 0)
    assert got[62] and not got[63] and not got[64] and got[65] and not got[66]
    _hold_model(boxes, valid, 0.5, 40, cluster=8)


def test_chunked_scan_model_duplicates_and_all_invalid():
    boxes = np.tile(np.array([[10.0, 10.0, 50.0, 50.0]], np.float32), (130, 1))
    got = _hold_model(boxes, np.ones(130, bool), 0.5, 0)
    assert got[0] and got.sum() == 1
    assert not _hold_model(boxes, np.zeros(130, bool), 0.5, 3).any()
