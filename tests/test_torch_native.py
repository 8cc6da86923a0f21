"""The port's host helpers (``mnc_tpu_torch/native.py``, numpy) against the
JAX package's C++ library (``mnc_tpu.native``, built here with g++), and the
port's host NMS (``ops/nms_wrapper.py``) against ``mnc_tpu/ops/nms_wrapper.py``,
on seeded boxes and masks, empty and full masks included.

Tolerances: RLE counts, decoded masks, mask IoUs and NMS keeps identical;
box IoUs within 2.5e-7 (the library is compiled with ``-march=native``, so
the compiler may fuse ``a + b - w·h`` into one rounding, which the f32
numpy expression takes in two: an ulp of a value below 1); mask voting
within 1e-5 (another order of the same f32 sums).
"""

import numpy as np
import pytest

from mnc_tpu import native as jnative
from mnc_tpu.ops import nms_wrapper as j_nms_wrapper
from mnc_tpu_torch import native
from mnc_tpu_torch.ops import nms_wrapper
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)


def _boxes(rs, n, size=100.0, span=60.0, clusters=0):
    if clusters:  # heavy overlap: jittered copies of a few boxes
        base = _boxes(rs, clusters, size, span)
        b = base[rs.randint(0, clusters, n)] + rs.uniform(-4, 4, (n, 4)).astype(np.float32)
        return np.ascontiguousarray(b, np.float32)
    x1 = rs.uniform(0, size, n)
    y1 = rs.uniform(0, size, n)
    return np.stack([x1, y1, x1 + rs.uniform(0, span, n),
                     y1 + rs.uniform(0, span, n)], 1).astype(np.float32)


def test_bbox_overlaps_matches_native():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 60), _boxes(rs, 45)
    b[:5] = a[:5]  # identical boxes: IoU 1
    b[5] = [500, 500, 510, 510]  # disjoint
    np.testing.assert_allclose(native.bbox_overlaps(a, b), jnative.bbox_overlaps(a, b),
                               rtol=0, atol=2.5e-7)
    assert native.bbox_overlaps(a, b).dtype == np.float32
    assert native.bbox_overlaps(a[:0], b).shape == (0, 45)


@pytest.mark.parametrize("clusters,thresh", [(0, 0.3), (0, 0.7), (6, 0.5), (3, 0.9)])
def test_cpu_nms_matches_native(clusters, thresh):
    rs = np.random.RandomState(clusters + int(thresh * 10))
    boxes = _boxes(rs, 300, clusters=clusters)
    np.testing.assert_array_equal(native.cpu_nms(boxes, thresh), jnative.cpu_nms(boxes, thresh))


def _masks(rs, n, h, w, p):
    m = rs.rand(n, h, w) < p
    m[0] = False  # empty
    m[1] = True  # full
    return m


def test_mask_iou_matrix_matches_native():
    rs = np.random.RandomState(1)
    a, b = _masks(rs, 6, 23, 31, 0.4), _masks(rs, 5, 23, 31, 0.6)
    got = native.mask_iou_matrix(a, b)
    np.testing.assert_array_equal(got, jnative.mask_iou_matrix(a, b))
    assert got[0, 0] == 0.0 and got[1, 1] == 1.0  # empty vs empty, full vs full


@pytest.mark.parametrize("kind", ["random", "empty", "full", "first pixel set",
                                  "last pixel set", "one row", "one column"])
def test_rle_roundtrip_matches_native(kind):
    rs = np.random.RandomState(2)
    h, w = (1, 40) if kind == "one row" else (40, 1) if kind == "one column" else (37, 29)
    m = {"empty": np.zeros((h, w)), "full": np.ones((h, w))}.get(kind, rs.rand(h, w) > 0.5)
    m = np.asarray(m, np.float32)
    if kind == "first pixel set":
        m[:] = 0
        m[0, 0] = 1
    if kind == "last pixel set":
        m[:] = 0
        m[-1, -1] = 1
    got, want = native.rle_encode(m), jnative.rle_encode(m)
    assert tuple(got["size"]) == tuple(want["size"]) == (h, w)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["counts"].dtype == np.int32 and got["counts"].sum() == h * w
    if m[0, 0]:
        assert got["counts"][0] == 0  # the first run counts zeros
    dec = native.rle_decode(got)
    assert dec.dtype == np.uint8
    np.testing.assert_array_equal(dec, jnative.rle_decode(want))
    np.testing.assert_array_equal(dec, (m > 0.5).astype(np.uint8))


def test_rle_decode_cuts_and_pads_as_native():
    """Runs past H·W are cut and pixels past the last run stay 0."""
    for counts in ([3, 100], [0, 2, 1], [5]):
        rle = {"size": (4, 5), "counts": np.asarray(counts, np.int32)}
        np.testing.assert_array_equal(native.rle_decode(rle), jnative.rle_decode(rle))


def test_mask_voting_matches_native():
    rs = np.random.RandomState(3)
    cand = _boxes(rs, 40, clusters=5)
    kept = cand[:8] + rs.uniform(-3, 3, (8, 4)).astype(np.float32)
    kept[7] = [500, 500, 520, 520]  # no candidate overlaps: all zeros
    scores = rs.rand(40).astype(np.float32)
    scores[::5] = 0.0  # zero scores never vote
    masks = rs.rand(40, 9, 9).astype(np.float32)
    got = native.mask_voting_cpu(kept, cand, scores, masks, 0.5)
    want = jnative.mask_voting_cpu(kept, cand, scores, masks, 0.5)
    assert got.shape == (8, 9, 9) and (want[:7] > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[7].any()


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_host_nms_matches_jax_wrapper(thresh):
    rs = np.random.RandomState(5)
    dets = np.concatenate([_boxes(rs, 200, clusters=8),
                           rs.rand(200, 1).astype(np.float32)], 1)
    dets[10:20, 4] = dets[0, 4]  # ties keep the lower index first
    np.testing.assert_array_equal(nms_wrapper.nms(dets, thresh), j_nms_wrapper.nms(dets, thresh))
    assert nms_wrapper.nms(dets[:0], thresh).shape == (0,)
    all_boxes = [[dets[:50], np.zeros((0, 5), np.float32)], [dets[50:120], dets[120:]]]
    got = nms_wrapper.apply_nms(all_boxes, thresh)
    want = j_nms_wrapper.apply_nms(all_boxes, thresh)
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
