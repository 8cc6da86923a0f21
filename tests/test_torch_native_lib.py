"""The port's compiled host helpers (``mnc_tpu_torch/csrc/native.cpp`` through
``mnc_tpu_torch/native.py``) against their numpy twins and against the JAX
package's library (``mnc_tpu.native``, the same algorithms, built with the
same g++ flags), on seeded boxes and masks; and the build: a missing or
failing compiler raises, several builds at once leave one library.

Tolerances: against ``mnc_tpu.native`` every function bit for bit.
Against the numpy twins, NMS keeps, mask IoUs, RLE counts and decoded masks
bit for bit; box IoUs within 2.5e-7 and host voting within 1e-5, because
``-march=native`` lets g++ fuse a multiply and an add into one rounding
(the union ``area_b + w·h``; the voting sums), which numpy takes in two.
"""

import os
import threading

import numpy as np
import pytest

from mnc_tpu import native as jnative
from mnc_tpu_torch import native
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)


def _boxes(rs, n, clusters=0):
    if clusters:
        base = _boxes(rs, clusters)
        b = base[rs.randint(0, clusters, n)] + rs.uniform(-4, 4, (n, 4))
        return np.ascontiguousarray(b, np.float32)
    x1, y1 = rs.uniform(0, 100, n), rs.uniform(0, 100, n)
    return np.stack([x1, y1, x1 + rs.uniform(0, 60, n), y1 + rs.uniform(0, 60, n)],
                    1).astype(np.float32)


def _masks(rs, n, h, w, p):
    m = rs.rand(n, h, w) < p
    m[0] = False
    m[1] = True
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_boxes_match_numpy_and_jax(seed):
    rs = np.random.RandomState(seed)
    a, b = _boxes(rs, 70), _boxes(rs, 55)
    b[:4] = a[:4]
    b[4] = [500, 500, 510, 510]
    got = native.bbox_overlaps(a, b)
    np.testing.assert_array_equal(got, jnative.bbox_overlaps(a, b))
    np.testing.assert_allclose(got, native.bbox_overlaps_plain(a, b), rtol=0, atol=2.5e-7)
    assert got.dtype == np.float32 and native.bbox_overlaps(a[:0], b).shape == (0, 55)
    for clusters, thresh in ((0, 0.3), (6, 0.5), (3, 0.9)):
        boxes = _boxes(rs, 250, clusters)
        keep = native.cpu_nms(boxes, thresh)
        np.testing.assert_array_equal(keep, jnative.cpu_nms(boxes, thresh))
        np.testing.assert_array_equal(keep, native.cpu_nms_plain(boxes, thresh))
        assert keep.dtype == np.bool_ and 0 < keep.sum() < len(keep)


def test_mask_iou_matches_numpy_and_jax():
    rs = np.random.RandomState(4)
    a, b = _masks(rs, 7, 29, 67, 0.4), _masks(rs, 5, 29, 67, 0.6)  # 1943 px: no whole word
    got = native.mask_iou_matrix(a, b)
    np.testing.assert_array_equal(got, jnative.mask_iou_matrix(a, b))
    np.testing.assert_array_equal(got, native.mask_iou_matrix_plain(a, b))
    np.testing.assert_array_equal(got, native.mask_iou_matrix(a.astype(np.float32) * 0.9,
                                                              b.astype(np.float32)))
    assert got[0, 0] == 0.0 and got[1, 1] == 1.0


@pytest.mark.parametrize("hw", [(37, 29), (1, 64), (64, 1), (480, 640)])
def test_rle_matches_numpy_and_jax(hw):
    rs = np.random.RandomState(hw[0])
    m = (rs.rand(*hw) > 0.5).astype(np.float32)
    if hw == (480, 640):  # a detection's full-resolution mask: one blob
        m[:] = 0
        m[100:300, 200:450] = 1
    for mask in (m, np.zeros(hw, np.float32), np.ones(hw, np.float32)):
        got = native.rle_encode(mask)
        for want in (jnative.rle_encode(mask), native.rle_encode_plain(mask)):
            assert tuple(got["size"]) == tuple(want["size"]) == hw
            np.testing.assert_array_equal(got["counts"], want["counts"])
        assert got["counts"].dtype == np.int32 and got["counts"].sum() == mask.size
        dec = native.rle_decode(got)
        np.testing.assert_array_equal(dec, (mask > 0.5).astype(np.uint8))
        np.testing.assert_array_equal(dec, native.rle_decode_plain(got))
        np.testing.assert_array_equal(dec, jnative.rle_decode(got))
    for counts in ([3, 100], [0, 2, 1], [5]):  # runs cut at H·W, the rest 0
        rle = {"size": (4, 5), "counts": np.asarray(counts, np.int32)}
        np.testing.assert_array_equal(native.rle_decode(rle), native.rle_decode_plain(rle))
        np.testing.assert_array_equal(native.rle_decode(rle), jnative.rle_decode(rle))


def test_mask_voting_matches_numpy_and_jax():
    rs = np.random.RandomState(3)
    cand = _boxes(rs, 40, clusters=5)
    kept = (cand[:8] + rs.uniform(-3, 3, (8, 4))).astype(np.float32)
    kept[7] = [500, 500, 520, 520]
    scores = rs.rand(40).astype(np.float32)
    scores[::5] = 0.0
    masks = rs.rand(40, 11, 11).astype(np.float32)
    got = native.mask_voting_cpu(kept, cand, scores, masks, 0.5)
    np.testing.assert_array_equal(got, jnative.mask_voting_cpu(kept, cand, scores, masks, 0.5))
    np.testing.assert_allclose(got, native.mask_voting_cpu_plain(kept, cand, scores, masks, 0.5),
                               rtol=0, atol=1e-5)
    assert (got[:7] > 0).any() and not got[7].any()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_failing_compiler_raises_with_its_output(monkeypatch, tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'native.cpp:1: error: it broke' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*it broke"):
        native.build()
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix in (".so", ".tmp")]


def test_concurrent_builds_leave_one_library(monkeypatch, tmp_path):
    """Four builds at once (as pytest-xdist workers at first use): each
    compiles to a name of its own and renames it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert sorted(os.listdir(tmp_path)) == [paths[0].name]
