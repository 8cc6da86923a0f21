"""The port's training data pipeline (``mnc_tpu_torch/data/loader.py``) and
MCG converter (``mnc_tpu_torch/tools/prepare_mcg_maskdb.py``) against the JAX
package's (``mnc_tpu/data/loader.py``, ``tools/prepare_mcg_maskdb.py``).

Inputs are made with numpy from seeds: ``SyntheticIMDB`` images and MCG
``.mat`` files written with ``scipy.io.savemat`` (the ``_mcg_mat`` pattern of
``tests/test_cfm.py``), superpixels from seeded overlapping rectangles, so
that the candidates' masks are not rectangles.

Tolerances: the loaders' order ((index, flipped) pairs) and every integer,
boolean and box array identical; images identical (synthetic canvases are
copied, uint8 canvases are bit-equal since the port's resize reproduces
cv2's arithmetic); resized masks within 1e-6 of cv2's INTER_AREA (the
port's ``resize_mask_area`` sums in float64 where cv2 sums in float32); the
float canvas path within 2e-5 (``tests/test_torch_host_api.py``).
"""

import pickle
import runpy
import sys

import cv2
import numpy as np
import pytest
from scipy.io import savemat

from mnc_tpu.data import loader as jloader
from mnc_tpu.data.synth_imdb import SyntheticIMDB as JSyntheticIMDB
from mnc_tpu_torch.data import loader
from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
from mnc_tpu_torch.tools import prepare_mcg_maskdb
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

CANVAS = (96, 128)
MASK_TOL = 1e-6


def mcg_mat(path, hw, segments, labels=None):
    """Write an MCG-format .mat: a superpixel label map (1 = background,
    rectangle k = label k + 2, later rectangles painted over earlier ones)
    and the candidates' label sets (default: candidate k = {k + 2})."""
    sp = np.ones(hw, np.int32)
    for sid, (y1, y2, x1, x2) in enumerate(segments, start=2):
        sp[y1:y2 + 1, x1:x2 + 1] = sid
    labels = labels if labels is not None else [[k + 2] for k in range(len(segments))]
    cell = np.empty((len(labels), 1), object)
    for k, ids in enumerate(labels):
        cell[k, 0] = np.array([ids], np.float64)
    savemat(path, {"superpixels": sp, "labels": cell})


def seeded_segments(rs, hw, n):
    h, w = hw
    out = []
    for _ in range(n):
        y1, x1 = rs.randint(0, h - 8), rs.randint(0, w - 8)
        out.append((y1, min(h - 1, y1 + rs.randint(4, h // 2)), x1,
                    min(w - 1, x1 + rs.randint(4, w // 2))))
    return out


def write_mcg_dir(root, image_ids, hw, seed=0):
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for image_id in image_ids:
        segs = seeded_segments(rs, hw, 7)
        # candidates: single superpixels, unions of two, and an empty one
        labels = [[k + 2] for k in range(7)] + [[2, 3], [4, 6, 8], [99]]
        mcg_mat(str(root / f"{image_id}.mat"), hw, segs, labels)


def run_jax_tool(argv):
    saved = sys.argv
    sys.argv = ["prepare_mcg_maskdb.py", *argv]
    sys.path.insert(0, "tools")
    try:
        runpy.run_path("tools/prepare_mcg_maskdb.py", run_name="__main__")
    finally:
        sys.path.pop(0)
        sys.argv = saved


def assert_records_equal(got, want):
    assert got["index"] == want["index"]
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    assert got["masks"].shape == want["masks"].shape and got["masks"].dtype == np.float32
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=MASK_TOL)


@pytest.fixture(scope="module")
def segdbs(tmp_path_factory):
    """The same MCG files converted by both tools for a 4-image synthetic
    imdb (ids 0..3), at mask size 13 and top-k 10 (the last candidate is
    empty)."""
    root = tmp_path_factory.mktemp("mcg")
    write_mcg_dir(root / "mcg", [0, 1, 2, 3], CANVAS)
    (root / "list.txt").write_text("0\n1\n2\n3\n")
    args = ["--mcg-dir", str(root / "mcg"), "--image-list", str(root / "list.txt"),
            "--mask-size", "13", "--top-k", "10"]
    assert prepare_mcg_maskdb.main([*args, "--out", str(root / "port")]) == 0
    run_jax_tool([*args, "--out", str(root / "jax")])
    return root / "port", root / "jax"


def test_prepare_mcg_maskdb_records_equal_the_jax_tool(segdbs):
    port, jax_dir = segdbs
    for i in range(4):
        with open(port / f"{i}.pkl", "rb") as f:
            got = pickle.load(f)
        with open(jax_dir / f"{i}.pkl", "rb") as f:
            want = pickle.load(f)
        assert_records_equal(got, want)
        assert 6 <= len(got["boxes"]) <= 9  # the empty candidate skipped
        assert ((got["masks"] > 0) & (got["masks"] < 1)).any()  # not just boxes


def test_prepare_mcg_maskdb_cli_skips_a_missing_mat(tmp_path):
    """``tests/test_cfm.py::test_prepare_mcg_maskdb_cli`` on the port."""
    mcg = tmp_path / "mcg"
    mcg.mkdir()
    mcg_mat(str(mcg / "img_a.mat"), (64, 80), [(5, 24, 10, 39), (30, 49, 20, 59)])
    (tmp_path / "list.txt").write_text("img_a\nmissing_img\n")
    out = tmp_path / "segdb"
    prepare_mcg_maskdb.main(["--mcg-dir", str(mcg), "--image-list",
                             str(tmp_path / "list.txt"), "--out", str(out),
                             "--mask-size", "9", "--top-k", "10"])
    with open(out / "img_a.pkl", "rb") as f:
        rec = pickle.load(f)
    assert rec["boxes"].shape == (2, 4) and rec["masks"].shape == (2, 9, 9)
    np.testing.assert_array_equal(rec["boxes"][0], [10, 5, 39, 24])
    np.testing.assert_allclose(rec["masks"], 1.0, atol=1e-5)  # box-filling segments
    assert not (out / "missing_img.pkl").exists()


@pytest.mark.parametrize("size,out", [((40, 30), 21), ((7, 50), 13), ((21, 21), 21),
                                      ((9, 12), 21), ((63, 17), 28)])
def test_crop_resize_within_tolerance_of_cv2(size, out):
    rs = np.random.RandomState(sum(size) + out)
    mask = rs.uniform(size=(size[0] + 6, size[1] + 4)) > 0.4
    box = np.array([2, 3, 2 + size[1] - 1, 3 + size[0] - 1], np.float32)
    got = prepare_mcg_maskdb.crop_resize(mask, box, out)
    crop = mask[3:3 + size[0], 2:2 + size[1]].astype(np.float32)
    want = cv2.resize(crop, (out, out), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_TOL)


def _with_width(imdb, width):
    """JAX's TrainLoader reads ``entry["width"]`` for a flipped image's
    segments, which a synthetic imdb's roidb lacks (a KeyError there); the
    port mirrors about the canvas width, as both do for the gt boxes."""
    db = imdb.roidb()
    for e in db:
        e["width"] = width
    imdb.roidb = lambda: db
    return imdb


def _loaders(segdb_dir=None, jax_segdb=None, **kw):
    kw = dict(dict(max_gt=8, canvas_hw=CANVAS, gt_mask_size=16, ims_per_batch=2,
                   use_flipped=True, seed=5, prefetch=2), **kw)
    imdb_kw = dict(canvas_hw=CANVAS, num_classes=4, num_images=4)
    port = loader.TrainLoader(SyntheticIMDB(**imdb_kw), segdb_dir=segdb_dir, seg_top_k=6,
                              seg_mask_size=11, **kw)
    jax = jloader.TrainLoader(_with_width(JSyntheticIMDB(**imdb_kw), CANVAS[1]),
                              segdb_dir=jax_segdb, seg_top_k=6, seg_mask_size=11, **kw)
    return port, jax


@pytest.mark.parametrize("with_segments", [False, True], ids=["gt", "segments"])
def test_train_loader_matches_the_jax_loader(segdbs, with_segments):
    """Two epochs of 4 images and their flips (8 batches of 2): the same
    (index, flipped) order, then equal batches through the prefetch
    thread."""
    port_dir, jax_dir = segdbs if with_segments else (None, None)
    port, jax = _loaders(port_dir, jax_dir)
    order = [port._next_index() for _ in range(16)]
    assert order == [jax._next_index() for _ in range(16)]
    assert sorted(order[:8]) == sorted(order[8:]) == [(i, f) for i in range(4)
                                                      for f in (False, True)]
    port, jax = _loaders(port_dir, jax_dir)
    try:
        for _ in range(8):
            got, want = next(port), jax._batch()
            assert set(got) == set(want)
            if with_segments:
                assert {"seg_boxes", "seg_masks", "seg_valid"} <= set(got)
                assert got["seg_valid"].sum(1).tolist() == [6, 6]
            for k, v in want.items():
                assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
                if k in ("gt_masks", "seg_masks"):
                    np.testing.assert_allclose(got[k], v, rtol=0, atol=MASK_TOL, err_msg=k)
                else:
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
    finally:
        port.close()
    assert not port._thread.is_alive()


def test_flipped_segments_mirror_about_the_width(segdbs):
    """A flipped example's segments are the unflipped ones mirrored (+1
    convention) with the masks' x reversed, and the cache keeps the
    unflipped arrays."""
    port, _ = _loaders(segdbs[0])
    a, b = port._make(2, False), port._make(2, True)
    w = CANVAS[1]
    np.testing.assert_array_equal(b["seg_boxes"][:, 0], w - a["seg_boxes"][:, 2] - 1)
    np.testing.assert_array_equal(b["seg_boxes"][:, 2], w - a["seg_boxes"][:, 0] - 1)
    np.testing.assert_array_equal(b["seg_masks"], a["seg_masks"][:, :, ::-1])
    np.testing.assert_array_equal(port._make(2, False)["seg_boxes"], a["seg_boxes"])


def test_train_loader_skip_and_errors(tmp_path):
    """``skip(n)`` gives the order of a loader that made n examples; a
    missing segment record is raised by ``next``."""
    a, _ = _loaders()
    b, _ = _loaders()
    [a._next_index() for _ in range(5)]
    b.skip(5)
    assert [a._next_index() for _ in range(7)] == [b._next_index() for _ in range(7)]
    c, _ = _loaders(str(tmp_path))
    try:
        with pytest.raises(FileNotFoundError, match="no segment proposals"):
            next(c)
    finally:
        c.close()
    with pytest.raises(RuntimeError):
        c.skip(1)


def test_train_loader_shapes_and_flip():
    """``tests/test_data_eval.py::test_train_loader_shapes_and_flip`` on the
    port."""
    imdb = SyntheticIMDB(canvas_hw=(96, 128), num_classes=4, num_images=4)
    ld = loader.TrainLoader(imdb, max_gt=8, canvas_hw=(96, 128), gt_mask_size=16,
                            ims_per_batch=2, use_flipped=True, prefetch=2)
    try:
        batch = next(ld)
    finally:
        ld.close()
    assert batch["image"].shape == (2, 96, 128, 3)
    assert batch["gt_boxes"].shape == (2, 8, 4)
    assert batch["gt_masks"].shape == (2, 8, 16, 16)
    assert batch["gt_valid"].any()
    b = batch["gt_boxes"][batch["gt_valid"]]
    assert (b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all()
    assert (b[:, 0] >= 0).all() and (b[:, 2] <= 127).all()


def test_make_example_zero_instances_with_mask_resize():
    """``tests/test_data_eval.py::test_make_example_zero_instances_with_mask_resize``
    on the port."""
    imdb = SyntheticIMDB(canvas_hw=(96, 128), num_classes=4, num_images=2)
    entry = dict(imdb.roidb()[0])
    entry["boxes"] = np.zeros((0, 4), np.float32)
    entry["classes"] = np.zeros((0,), np.int32)
    masks = {"masks": np.zeros((0, 112, 112), np.float32)}  # != gt_mask_size
    ex = loader.make_example(imdb, entry, masks, 0, max_gt=8, canvas_hw=(96, 128),
                             gt_mask_size=16, synthetic=True)
    assert not ex["gt_valid"].any()
    assert ex["gt_masks"].shape == (8, 16, 16)


class _DiskImdb:
    """Two images on disk (cv2-written PNGs): what make_example reads of a
    real imdb."""

    def __init__(self, root):
        rs = np.random.RandomState(4)
        self.paths = []
        for i, (h, w) in enumerate([(60, 90), (75, 50)]):
            p = str(root / f"im{i}.png")
            cv2.imwrite(p, rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
            self.paths.append(p)

    def image_path_at(self, i):
        return self.paths[i]


@pytest.mark.parametrize("u8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("flipped", [False, True], ids=["plain", "flipped"])
def test_make_example_real_image_matches_jax(tmp_path, u8, flipped):
    """The real-image branch: cv2.imread, the reference scale rule into the
    canvas (uint8 bit-equal, float within 2e-5), gt boxes scaled, gt masks
    resized 20 → 16."""
    imdb = _DiskImdb(tmp_path)
    rs = np.random.RandomState(1)
    entry = {"boxes": np.array([[3, 4, 40, 50], [10, 2, 20, 30]], np.float32),
             "classes": np.array([2, 1], np.int32), "flipped": flipped}
    masks = {"masks": (rs.uniform(size=(2, 20, 20)) > 0.5).astype(np.float32)}
    kw = dict(max_gt=4, canvas_hw=(64, 96), gt_mask_size=16, train_scales=(48,),
              max_size=96, u8=u8)
    for i in (0, 1):
        got = loader.make_example(imdb, entry, masks, i, **kw)
        want = jloader.make_example(imdb, entry, masks, i, **kw)
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if u8:
            np.testing.assert_array_equal(got["image"], want["image"])
        else:
            np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["gt_masks"], want["gt_masks"], rtol=0, atol=MASK_TOL)
        for k in ("im_info", "gt_boxes", "gt_classes", "gt_valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_image_raises_for_an_unreadable_file(tmp_path):
    class Missing:
        def image_path_at(self, i):
            return str(tmp_path / "none.png")

    with pytest.raises(FileNotFoundError):
        loader.load_image(Missing(), 0)
