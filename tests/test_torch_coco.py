"""The port's COCO reader (``mnc_tpu_torch/data/coco.py``), its
``tools/make_coco_synth.py`` and ``train_net`` / ``test_net --coco-ap`` over
COCO trees, against the JAX package (``mnc_tpu/data/coco.py``,
``tools/make_coco_synth.py``, ``tools/test_net.py``).

Trees: ``tests/test_coco.py::_tiny_coco`` (polygons), the synthetic shapes
tree both ``make_coco_synth`` tools emit (jpgs; polygons and RLE), and the
tree ``chip_smoke.py`` phase 4j writes without cv2 (PNG images, RLE only,
COCO's 80 category ids, a crowd and a tiny annotation that the reader
leaves out).  The two packages cache their roidbs in different directories.

Everything here is exact: RLE strings and masks, rasterized polygons,
records, ``TrainLoader`` batches (the port's resize reproduces cv2's uint8
arithmetic), the emitted json and jpg bytes, and the AP tables of
``test_net --coco-ap`` on one npz (JAX pastes in f32, as the port does).
"""

import contextlib
import io
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from mnc_tpu.data import coco as jcoco
from mnc_tpu.data import loader as jloader
from mnc_tpu_torch.data import coco, loader
from tests.test_coco import _tiny_coco
from tests.test_torch_real_data import (_table, cfgs_restored, run_jax_test_net,
                                        run_port_test_net)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)


def _random_masks(rs, n=12):
    out = [np.zeros((5, 9), np.uint8), np.ones((5, 9), np.uint8), np.zeros((1, 1), np.uint8)]
    for _ in range(n):
        h, w = rs.randint(1, 70, size=2)
        out.append((rs.uniform(size=(h, w)) > rs.uniform(0.1, 0.9)).astype(np.uint8))
    big = np.zeros((300, 400), np.uint8)  # long runs: multi-byte LEB-5 counts and deltas
    big[40:260, 17:333] = 1
    big[100:120, :] ^= 1
    return out + [big]


def test_rle_both_directions_equal_jax():
    rs = np.random.RandomState(0)
    for m in _random_masks(rs):
        got, want = coco.encode_coco_rle(m), jcoco.encode_coco_rle(m)
        assert got == want
        counts = jcoco._decode_rle_string(want["counts"])
        assert coco._decode_rle_string(want["counts"]) == counts
        assert coco._encode_rle_string(counts) == jcoco._encode_rle_string(counts)
        h, w = m.shape
        for c in (want["counts"], counts):
            dec = coco.decode_coco_rle(c, h, w)
            assert dec.dtype == np.uint8
            np.testing.assert_array_equal(dec, jcoco.decode_coco_rle(c, h, w))
            np.testing.assert_array_equal(dec, m)


def test_polygons_to_mask_equal_jax():
    rs = np.random.RandomState(1)
    for _ in range(20):
        h, w = rs.randint(8, 60, size=2)
        polys = [rs.uniform(-3, [w + 3, h + 3], size=(rs.randint(3, 9), 2)).reshape(-1).tolist()
                 for _ in range(rs.randint(1, 3))]
        got = coco.polygons_to_mask(polys, h, w)
        np.testing.assert_array_equal(got, jcoco.polygons_to_mask(polys, h, w))
        ann = {"segmentation": polys}
        np.testing.assert_array_equal(coco.annotation_to_mask(ann, h, w),
                                      jcoco.annotation_to_mask(ann, h, w))


def test_polygons_without_cv2_raise_naming_the_annotation(monkeypatch):
    """Where cv2 does not import a polygon is an error that names its
    annotation; RLE still decodes."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    ann = {"id": 17, "image_id": 4, "segmentation": [[0, 0, 5, 0, 5, 5]]}
    with pytest.raises(RuntimeError, match="COCO annotation 17 of image 4.*cv2"):
        coco.annotation_to_mask(ann, 8, 8)
    m = np.eye(6, dtype=np.uint8)
    np.testing.assert_array_equal(
        coco.annotation_to_mask({"segmentation": coco.encode_coco_rle(m)}, 6, 6), m)


def assert_coco_records_equal(port, want):
    assert port.classes == want.classes and port.name == want.name
    assert port.image_index == want.image_index
    for i in range(port.num_images):
        assert port.image_path_at(i) == want.image_path_at(i)
    got_db, want_db = port.roidb(), want.roidb()
    assert len(got_db) == len(want_db) > 0
    for g, w in zip(got_db, want_db):
        assert set(g) == set(w) and g["index"] == w["index"] and not g["flipped"]
        for k in ("boxes", "classes", "masks"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for g, w in zip(port.maskdb(), want.maskdb()):
        np.testing.assert_array_equal(g["masks"], w["masks"])
    got, want_gt = port.gt_instances(), want.gt_instances()
    assert list(got) == list(want_gt)
    for k in want_gt:
        assert [g["class_id"] for g in got[k]] == [w["class_id"] for w in want_gt[k]]
        for g, w in zip(got[k], want_gt[k]):
            np.testing.assert_array_equal(g["mask"], w["mask"])


def _pair(root, split, tmp_path, **kw):
    return (coco.COCOSeg(split, root=root, cache_dir=str(tmp_path / "port_cache"), **kw),
            jcoco.COCOSeg(split, root=root, cache_dir=str(tmp_path / "jax_cache"), **kw))


def test_tiny_coco_records_equal_jax(tmp_path):
    port, want = _pair(_tiny_coco(tmp_path), "tiny", tmp_path, gt_mask_size=8)
    assert_coco_records_equal(port, want)
    assert (tmp_path / "port_cache" / "coco_tiny_roidb.pkl").exists()


@pytest.fixture(scope="module")
def synth_trees(tmp_path_factory):
    """The shapes tree emitted by both packages' make_coco_synth."""
    sys.path.insert(0, "tools")
    try:
        from make_coco_synth import emit_coco_synth as j_emit
    finally:
        sys.path.pop(0)
    from mnc_tpu_torch.tools.make_coco_synth import emit_coco_synth

    d = tmp_path_factory.mktemp("coco_synth")
    kw = dict(canvas_hw=(64, 96), num_classes=4, n_range=(1, 3), seed=5)
    with contextlib.redirect_stdout(io.StringIO()):
        emit_coco_synth(str(d / "port"), "mini", 4, **kw)
        j_emit(str(d / "jax"), "mini", 4, **kw)
    return d


def test_make_coco_synth_emits_the_jax_tree(synth_trees):
    d = synth_trees
    read = lambda root: json.load(open(root / "annotations" / "instances_mini.json"))  # noqa
    got, want = read(d / "port"), read(d / "jax")
    assert got == want
    assert {type(a["segmentation"]) for a in got["annotations"]} == {list, dict}
    for im in want["images"]:
        for root in ("port", "jax"):
            assert (d / root / "images" / "mini" / im["file_name"]).exists()
        assert ((d / "port" / "images" / "mini" / im["file_name"]).read_bytes()
                == (d / "jax" / "images" / "mini" / im["file_name"]).read_bytes())


def test_make_coco_synth_cli(tmp_path):
    from mnc_tpu_torch.tools import make_coco_synth

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert make_coco_synth.main(["--root", str(tmp_path), "--splits", "a=2", "--canvas",
                                     "48", "64", "--num-classes", "3"]) == 0
    assert osp.exists(tmp_path / "coco" / "annotations" / "instances_a.json")
    assert "use with --set DATA_DIR" in buf.getvalue()


@pytest.fixture(scope="module")
def png_coco(tmp_path_factory):
    """chip_smoke.py phase 4j's COCO tree at small sizes (DATA_DIR)."""
    data = tmp_path_factory.mktemp("png_coco")
    chip_smoke.write_coco_tree(str(data / "coco"), "synth", n_images=3,
                               sizes=((60, 80), (80, 60)), seed=1)
    return data


@pytest.mark.parametrize("tree", ["synth", "png"])
def test_coco_records_equal_jax(synth_trees, png_coco, tmp_path, tree):
    """Records of a tree with polygons and RLE (jpgs), and of the PNG tree
    (80 categories with COCO's ids: 81 classes; crowd and tiny annotations
    left out); the ground truth fed back as detections scores 1.0 averaged
    over the thresholds."""
    root, split = ((str(synth_trees / "port"), "mini") if tree == "synth"
                   else (str(png_coco / "coco"), "synth"))
    port, want = _pair(root, split, tmp_path)
    assert_coco_records_equal(port, want)
    if tree == "png":
        assert port.num_classes == 81
        n_ann = len(json.load(open(port._ann_path))["annotations"])
        assert sum(len(e["boxes"]) for e in port.roidb()) == n_ann - 2
    gt = port.gt_instances()
    dets = [{"image_id": i, "class_id": g["class_id"], "score": 1.0, "mask": g["mask"]}
            for i, gs in gt.items() for g in gs]
    res = port.evaluate(dets, iou_threshs=(0.5, "avg"))
    assert res[0.5]["map"] == pytest.approx(1.0) and res["avg"]["map"] == pytest.approx(1.0)


def test_train_loader_batches_equal_jax(synth_trees, tmp_path):
    port_imdb, jax_imdb = _pair(str(synth_trees / "port"), "mini", tmp_path)
    kw = dict(max_gt=4, canvas_hw=(64, 96), gt_mask_size=21, ims_per_batch=2,
              use_flipped=True, seed=2, prefetch=1)
    with cfgs_restored():
        from mnc_tpu import config as jconfig
        from mnc_tpu_torch import config as pconfig

        for c in (pconfig.cfg, jconfig.cfg):
            c.TRAIN.SCALES, c.TRAIN.MAX_SIZE = (48,), 96
        port, want = loader.TrainLoader(port_imdb, **kw), jloader.TrainLoader(jax_imdb, **kw)
        try:
            for _ in range(4):
                g, w = next(port), next(want)
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        finally:
            port.close()


COCO_SET = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32",
            "STATIC.CANVAS", "[64, 96]", "NET.ANCHOR_SCALES", "[1, 2, 4]", "NET.NUM_CLASSES",
            "81"]


def test_train_net_over_coco(png_coco, tmp_path):
    """``train_net --imdb coco_synth --device cpu``: the class count from the
    json (81), 2 finite steps through ``TrainLoader``."""
    from mnc_tpu_torch.tools import train_net

    buf = io.StringIO()
    with cfgs_restored(), contextlib.redirect_stdout(buf):
        assert train_net.main(["--imdb", "coco_synth", "--device", "cpu", "--iters", "2",
                               "--print-every", "1", "--out", str(tmp_path / "run"), "--set",
                               *COCO_SET, "TRAIN.SCALES", "[48]", "TRAIN.MAX_SIZE", "96",
                               "NET.N_STAGES", "3", "STATIC.TRAIN_PRE_NMS_TOP_N", "64",
                               "STATIC.TRAIN_POST_NMS_TOP_N", "16", "TRAIN.BATCH_SIZE", "16",
                               "DATA_DIR", str(png_coco)]) == 0
    assert "81 classes" in buf.getvalue()
    lines = (tmp_path / "run" / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert all(np.isfinite(v) for ln in lines for v in json.loads(ln).values())


def test_test_net_coco_ap_equals_the_jax_tool(png_coco, tmp_path):
    """``test_net --imdb coco_synth --coco-ap`` over the PNG tree prints the
    JAX tool's AP tables (0.5, 0.7 and the average over [.5:.95]) on one
    npz of the 81-class head."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz

    npz = str(tmp_path / "coco_small.npz")
    arch = MNCArch(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=81, fc_dim=64,
                   mask_fc_dim=32, compute_dtype=torch.float32)
    save_npz(npz, jax_params_from_state_dict(MNC(arch, device="cpu", seed=5).state_dict()),
             {"bbox_pred_normalized": True})
    argv = ["--imdb", "coco_synth", "--npz", npz, "--stages", "3", "--coco-ap", "--set",
            *COCO_SET, "TEST.SCALES", "[48]", "TEST.MAX_SIZE", "96",
            "STATIC.TEST_PRE_NMS_TOP_N", "64", "STATIC.TEST_POST_NMS_TOP_N", "16",
            "DATA_DIR", str(png_coco)]
    got = run_port_test_net(argv)
    assert "AP^r@[.5:.95] = " in got
    assert _table(got) == _table(run_jax_test_net(argv))
