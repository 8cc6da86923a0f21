"""The port's VOC and SBD readers (``mnc_tpu_torch/data/pascal_voc.py``) and
``train_net`` / ``test_net`` over real-format trees, against the JAX
package (``mnc_tpu/data/pascal_voc.py``, ``tools/train_net.py``,
``tools/test_net.py``).

Trees: the miniature SBD and VOC trees of ``tests/test_real_data.py``
(``sbd_root``, ``voc_root``: cv2-written jpgs) and the SBD tree that
``chip_smoke.py`` phase 4j writes without cv2 (PNG bytes under the
reference's ``.jpg`` names, ``GTinst`` / ``GTcls`` structs from
``scipy.io.savemat``), here at small sizes of both orientations.  The two
packages cache their maskdbs in different directories, so neither reads
the other's pickle.

Tolerances: image index, paths, boxes, classes and ground-truth masks
identical; maskdb masks within 1e-6 (``resize_mask_area`` sums in float64
where cv2 sums in float32); ``TrainLoader`` batches identical (the port's
resize reproduces cv2's uint8 arithmetic); ``train_net`` resumed from a
snapshot bit-equal to the uninterrupted run; ``--weights`` leaves equal to
the JAX loaders' on the same tree; the AP tables of ``test_net`` (plain and
``--segdb``) equal to the JAX tool's on one npz (JAX pastes in f32 here,
``TEST.PASTE_DTYPE f32``, as the port does).
"""

import contextlib
import io
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from mnc_tpu import config as jconfig
from mnc_tpu.data import loader as jloader
from mnc_tpu.data import pascal_voc as jpv
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch.data import loader, pascal_voc as pv
from mnc_tpu_torch.data.imdb import get_imdb
from tests.test_real_data import SBD_IMAGES, sbd_root, voc_root  # noqa: F401  (fixtures)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

MASK_TOL = 1e-6
SIZES = ((60, 80), (80, 60))  # both orientations; the portrait one pads to the right
SMALL = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32",
         "STATIC.CANVAS", "[64, 96]", "NET.ANCHOR_SCALES", "[1, 2, 4]"]
TEST_SET = SMALL + ["TEST.SCALES", "[48]", "TEST.MAX_SIZE", "96",
                    "STATIC.TEST_PRE_NMS_TOP_N", "64", "STATIC.TEST_POST_NMS_TOP_N", "16"]
TRAIN_SET = SMALL + ["TRAIN.SCALES", "[48]", "TRAIN.MAX_SIZE", "96", "NET.N_STAGES", "3",
                     "STATIC.TRAIN_PRE_NMS_TOP_N", "64", "STATIC.TRAIN_POST_NMS_TOP_N", "16",
                     "TRAIN.BATCH_SIZE", "16", "TRAIN.RPN_BATCHSIZE", "64"]


@contextlib.contextmanager
def cfgs_restored():
    saved = pconfig.cfg.clone(), jconfig.cfg.clone()
    try:
        yield
    finally:
        for c, s in zip((pconfig.cfg, jconfig.cfg), saved):
            c.clear()
            c.update(s)


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """``chip_smoke.write_sbd_tree`` at small sizes: DATA_DIR with sbd/."""
    data = tmp_path_factory.mktemp("png_tree")
    ids = chip_smoke.write_sbd_tree(str(data / "sbd"), n_images=4, sizes=SIZES, seed=0)
    return data, ids


def _seg_pair(root, tmp_path, image_set="train", **kw):
    return (pv.PascalVOCSeg(image_set, str(root), cache_dir=str(tmp_path / "port_cache"), **kw),
            jpv.PascalVOCSeg(image_set, str(root), cache_dir=str(tmp_path / "jax_cache"), **kw))


def assert_records_equal(port, jax_imdb):
    assert port.name == jax_imdb.name and port.classes == jax_imdb.classes
    assert port.image_index == jax_imdb.image_index
    for i in range(port.num_images):
        assert port.image_path_at(i) == jax_imdb.image_path_at(i)
    got, want = port.roidb(), jax_imdb.roidb()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["index"] == w["index"] and g["flipped"] == w["flipped"]
        for k in ("boxes", "classes"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(port.maskdb(), jax_imdb.maskdb()):
        assert g["masks"].shape == w["masks"].shape and g["masks"].dtype == np.float32
        np.testing.assert_allclose(g["masks"], w["masks"], rtol=0, atol=MASK_TOL)
    got, want = port.gt_instances(), jax_imdb.gt_instances()
    assert list(got) == list(want)
    for k in want:
        assert [g["class_id"] for g in got[k]] == [w["class_id"] for w in want[k]]
        for g, w in zip(got[k], want[k]):
            assert g["mask"].dtype == w["mask"].dtype
            np.testing.assert_array_equal(g["mask"], w["mask"])


@pytest.mark.parametrize("size", [112, 21])
def test_sbd_records_equal_jax(sbd_root, tmp_path, size):  # noqa: F811
    port, jax_imdb = _seg_pair(sbd_root, tmp_path, gt_mask_size=size)
    assert_records_equal(port, jax_imdb)
    cache = tmp_path / "port_cache" / f"voc_2012_seg_train_s{size}_maskdb.pkl"
    assert cache.exists()
    again = pv.PascalVOCSeg("train", str(sbd_root), gt_mask_size=size,
                            cache_dir=str(tmp_path / "port_cache"))
    np.testing.assert_array_equal(again.maskdb()[0]["masks"], port.maskdb()[0]["masks"])


def test_png_sbd_tree_records_and_images_equal_jax(png_tree, tmp_path):
    """The tree of chip_smoke.py phase 4j: records as the JAX reader's, and
    every image (PNG bytes named .jpg) read by ``load_image`` as cv2 reads
    it; the ground truth fed back as detections scores 1.0."""
    data, ids = png_tree
    port, jax_imdb = _seg_pair(data / "sbd", tmp_path, "val")
    assert_records_equal(port, jax_imdb)
    assert port.image_index == ids
    for i in range(port.num_images):
        with open(port.image_path_at(i), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        im = loader.load_image(port, i)
        assert im.shape[:2] == SIZES[i % 2]
        np.testing.assert_array_equal(im, cv2.imread(port.image_path_at(i)))
    gt = port.gt_instances()
    dets = [{"image_id": i, "class_id": g["class_id"], "score": 1.0, "mask": g["mask"]}
            for i, gs in gt.items() for g in gs]
    assert all(r["map"] == pytest.approx(1.0) for r in port.evaluate(dets).values())


def test_voc_det_records_equal_jax(voc_root):  # noqa: F811
    port = pv.PascalVOCDet("train", devkit_path=str(voc_root))
    want = jpv.PascalVOCDet("train", devkit_path=str(voc_root))
    assert port.image_index == want.image_index and port.name == want.name
    assert [port.image_path_at(i) for i in range(2)] == [want.image_path_at(i) for i in range(2)]
    for g, w in zip(port.roidb(), want.roidb()):
        assert g["index"] == w["index"] and g["flipped"] == w["flipped"]
        for k in ("boxes", "classes"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_get_imdb_resolves_every_jax_name(voc_root, sbd_root, tmp_path):  # noqa: F811
    """``data.imdb.get_imdb`` (where the tools import it) and
    ``data.pascal_voc.get_imdb`` resolve the JAX factory's names to the
    same kinds of imdb over the same files, and registered names first."""
    names = {"voc_2012_train": (pv.PascalVOCDet, jpv.PascalVOCDet),
             "voc_2012_seg_train": (pv.PascalVOCSeg, jpv.PascalVOCSeg),
             "coco_synth": (None, None), "synthetic_8": (None, None)}
    with cfgs_restored():
        for c in (pconfig.cfg, jconfig.cfg):
            c.DATA_DIR = str(voc_root.parent)
        for name, (kind, jkind) in names.items():
            got, want = get_imdb(name), jpv.get_imdb(name)
            assert type(got).__name__ == type(want).__name__ and got.name == want.name
            if kind is not None:
                assert isinstance(got, kind) and isinstance(want, jkind)
        assert get_imdb("voc_2012_train").roidb()[0]["index"] == "2012_0001"
        assert get_imdb("synthetic_8").num_images == 8
        pv.register_imdb("voc_fixture_seg", lambda: pv.PascalVOCSeg(
            "train", str(sbd_root), cache_dir=str(tmp_path / "cache")))
        try:
            assert get_imdb("voc_fixture_seg").image_index == [i for i, _, _ in SBD_IMAGES]
        finally:
            pv._FACTORY.pop("voc_fixture_seg")
        with pytest.raises(KeyError):
            get_imdb("imagenet")


@pytest.mark.parametrize("ims", [1, 2])
def test_train_loader_batches_equal_jax(png_tree, tmp_path, ims):
    """Two epochs of the PNG tree with flips: the port's ``TrainLoader`` and
    the JAX package's give the same batches (JAX reads the PNGs with cv2)."""
    data, _ = png_tree
    port_imdb, jax_imdb = _seg_pair(data / "sbd", tmp_path, gt_mask_size=28)
    kw = dict(max_gt=4, canvas_hw=(64, 96), gt_mask_size=16, ims_per_batch=ims,
              use_flipped=True, seed=5, prefetch=2)
    with cfgs_restored():
        for c in (pconfig.cfg, jconfig.cfg):
            c.TRAIN.SCALES, c.TRAIN.MAX_SIZE = (48,), 96
        port = loader.TrainLoader(port_imdb, **kw)
        want = jloader.TrainLoader(jax_imdb, **kw)
        try:
            for _ in range(8 // ims):
                g, w = next(port), next(want)
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    if k == "gt_masks":
                        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=MASK_TOL)
                    else:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        finally:
            port.close()


def test_train_net_trains_and_resumes_bit_exactly_over_sbd(png_tree, tmp_path):
    """``train_net --imdb voc_2012_seg_train --device cpu``: 4 steps through
    ``TrainLoader``; a run interrupted after 2 and resumed (the loader
    advanced past the examples taken) ends with the same parameters and
    solver state bit for bit, and logs the same losses."""
    from mnc_tpu_torch.tools import train_net
    from mnc_tpu_torch.utils.checkpoint import checkpoint_npz

    data, _ = png_tree
    argv = ["--imdb", "voc_2012_seg_train", "--device", "cpu", "--print-every", "1",
            "--set", *TRAIN_SET, "DATA_DIR", str(data)]
    full, cut = tmp_path / "full", tmp_path / "cut"
    buf = io.StringIO()
    with cfgs_restored(), contextlib.redirect_stdout(buf):
        assert train_net.main([*argv, "--iters", "4", "--out", str(full)]) == 0
    assert "21 classes" in buf.getvalue() and "canvas (64, 96)" in buf.getvalue()
    with cfgs_restored():
        assert train_net.main([*argv, "--iters", "2", "--out", str(cut)]) == 0
    buf = io.StringIO()
    with cfgs_restored(), contextlib.redirect_stdout(buf):
        assert train_net.main([*argv, "--iters", "4", "--out", str(cut)]) == 0
    assert "resumed from iter 2" in buf.getvalue()
    a, b = np.load(checkpoint_npz(str(full))), np.load(checkpoint_npz(str(cut)))
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    la = (full / "train_metrics.jsonl").read_text().splitlines()
    lb = (cut / "train_metrics.jsonl").read_text().splitlines()
    strip = lambda ln: {k: v for k, v in __import__("json").loads(ln).items()  # noqa: E731
                        if k != "time"}
    assert len(la) == len(lb) == 4 and [strip(x) for x in la] == [strip(x) for x in lb]
    assert all(np.isfinite(v) for ln in la for v in strip(ln).values())


# --------------------------------------------------------------------------- #
# --weights
# --------------------------------------------------------------------------- #


def _weights_file(fmt, tmp_path, rs):
    """A weights file of each kind --weights takes, seeded."""
    from tests.test_torch_resnet import _torchvision_state_dict
    from tests.test_torch_weights_import import _random_tv_state_dict

    if fmt == "vgg-caffe-npz":
        arrays, prev = {}, 3
        chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
        from mnc_tpu_torch.utils.weights import _VGG_CAFFE_NAMES

        for name, co in zip(_VGG_CAFFE_NAMES, chans):
            arrays[f"{name}_w"] = (rs.randn(co, prev, 3, 3) * 0.05).astype(np.float32)
            arrays[f"{name}_b"] = (rs.randn(co) * 0.05).astype(np.float32)
            prev = co
        path = str(tmp_path / "vgg16.npz")
        np.savez(path, **arrays)
    elif fmt == "caffemodel":
        from mnc_tpu_torch.tools import fabricate_caffemodel as fab
        from mnc_tpu_torch.utils.caffemodel import write_caffemodel

        path = str(tmp_path / "mnc.caffemodel")
        write_caffemodel(path, fab.fabricate_blobs(fc_dim=64, mask_fc_dim=32, seed=1))
    elif fmt == "vgg-torchvision":
        path = str(tmp_path / "vgg16.pth")
        torch.save(_random_tv_state_dict(rs), path)
    else:
        path = str(tmp_path / "resnet50.pth")
        torch.save({k: torch.from_numpy(np.asarray(v))
                    for k, v in _torchvision_state_dict().items()}, path)
    return path


@pytest.mark.parametrize("fmt", ["vgg-caffe-npz", "caffemodel", "vgg-torchvision",
                                 "resnet-torchvision"])
def test_train_net_weights_equal_the_jax_loaders(tmp_path, fmt):
    """``train_net.load_weights`` into a train model: every leaf equal to
    what the JAX tool's loader (``tools/train_net.py``) makes of the same
    initial tree; ``main --weights`` runs a step from it; torchvision ResNet
    weights turn on ``NET.RESNET_STRIDE_IN_3X3``."""
    from mnc_tpu.utils import caffemodel as jcaffe, checkpoint as jckpt, weights as jweights
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.tools import train_net
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict
    from tests.test_torch_resnet import _leaves

    resnet = fmt.startswith("resnet")
    path = _weights_file(fmt, tmp_path, np.random.RandomState(7))
    kw = dict(canvas=(64, 96), anchor_scales=(1, 2, 4), fc_dim=64, mask_fc_dim=32,
              compute_dtype=torch.float32, pre_nms_top_n=64, post_nms_top_n=16)
    if resnet:
        kw.update(trunk="resnet50", roi_conv5=True, resnet_stride_in_3x3=True)
    arch = MNCArch(**kw)
    model = MNC(arch, device="cpu", seed=2, train=True)
    params = jax_params_from_state_dict(model.state_dict())
    if fmt == "vgg-caffe-npz":
        want = jweights.load_vgg16_caffe_npz(path, params)
    elif fmt == "caffemodel":
        want = jckpt.renormalize_bbox_pred(jcaffe.load_mnc_caffemodel(path, params),
                                           arch.bbox_means, arch.bbox_stds)
    elif fmt == "vgg-torchvision":
        want = jweights.load_vgg16_torchvision(params, weights_path=path)
    else:
        want = jweights.load_resnet_torchvision(params, weights_path=path, depth=50)
    with contextlib.redirect_stdout(io.StringIO()):
        train_net.load_weights(model, path, arch)
    got = _leaves(jax_params_from_state_dict(model.state_dict()))
    want = _leaves(want)
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 if resnet else 0, err_msg=k)
        moved += not np.array_equal(w, _leaves(params)[k])
    assert moved >= (13 if fmt.startswith("vgg") else 20)

    data = tmp_path / "data"
    chip_smoke.write_sbd_tree(str(data / "sbd"), n_images=2, sizes=SIZES, seed=3)
    extra = ["NET.TRUNK", "resnet50", "NET.ROI_CONV5", "True"] if resnet else []
    buf = io.StringIO()
    with cfgs_restored(), contextlib.redirect_stdout(buf):
        assert train_net.main(["--imdb", "voc_2012_seg_train", "--device", "cpu", "--iters",
                               "1", "--weights", path, "--out", str(tmp_path / "run"),
                               "--set", *TRAIN_SET, "DATA_DIR", str(data), *extra]) == 0
        assert pconfig.cfg.NET.RESNET_STRIDE_IN_3X3 is resnet
    assert f"initialized from {path}" in buf.getvalue()
    assert ("enabling NET.RESNET_STRIDE_IN_3X3" in buf.getvalue()) is resnet


# --------------------------------------------------------------------------- #
# test_net over the tree, against the JAX tool
# --------------------------------------------------------------------------- #


def _small_npz(path):
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz

    arch = MNCArch(canvas=(64, 96), anchor_scales=(1, 2, 4), fc_dim=64, mask_fc_dim=32,
                   compute_dtype=torch.float32)
    save_npz(path, jax_params_from_state_dict(MNC(arch, device="cpu", seed=4).state_dict()),
             {"bbox_pred_normalized": True})
    return path


def _table(text):
    lines = text.splitlines()
    return "\n".join(lines[next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~")):])


def run_port_test_net(argv):
    from mnc_tpu_torch.tools import test_net

    buf = io.StringIO()
    with cfgs_restored(), contextlib.redirect_stdout(buf):
        assert test_net.main([*argv, "--device", "cpu"]) == 0
    return buf.getvalue()


def run_jax_test_net(argv):
    """The JAX package's ``tools/test_net.py`` in this process (as
    ``tests/test_cfm.py`` runs it), pasting in f32 as the port does."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["test_net.py", "--cpu", *argv, "TEST.PASTE_DTYPE", "f32"]
    sys.path.insert(0, "tools")
    try:
        with cfgs_restored(), contextlib.redirect_stdout(buf):
            runpy.run_path("tools/test_net.py", run_name="__main__")
    finally:
        sys.path.pop(0)
        sys.argv = saved
    return buf.getvalue()


@pytest.fixture(scope="module")
def voc_eval(png_tree, tmp_path_factory):
    """One small npz and an oracle segdb (each image's gt instances) over
    the PNG tree."""
    data, _ = png_tree
    d = tmp_path_factory.mktemp("voc_eval")
    imdb = pv.PascalVOCSeg("val", str(data / "sbd"), cache_dir=str(d / "cache"))
    return data, _small_npz(str(d / "small.npz")), chip_smoke.oracle_segdb(imdb, str(d / "segdb"))


@pytest.mark.parametrize("mode", ["detect", "segdb"])
def test_test_net_ap_table_equals_the_jax_tool(voc_eval, mode):
    """``test_net --imdb voc_2012_seg_val`` over real images (read by the
    PNG reader; ``pipe.detect``; or ``--segdb``: scale, segdb boxes scaled,
    canvas masks cropped and resized back) prints the JAX tool's AP table
    on the same npz."""
    data, npz, segdb = voc_eval
    argv = ["--imdb", "voc_2012_seg_val", "--npz", npz, "--stages", "3"]
    if mode == "segdb":
        argv += ["--segdb", segdb, "--seg-top-k", "8"]
    argv += ["--set", *TEST_SET, "DATA_DIR", str(data)]
    got = run_port_test_net(argv)
    want = run_jax_test_net(argv)
    assert _table(got) == _table(want)
    assert "mAP^r@0.5 = " in got


def test_cfm_real_image_chain_oracle(tmp_path):
    """``tests/test_cfm.py::test_cfm_real_image_chain_oracle`` on the port:
    ``test_net --segdb`` over real images (a landscape and a portrait one,
    one class-1 instance each) with the ground truth as the segments scores
    1.0 after decode, scale, scaled segdb boxes, unmold and the ``.mat``
    ground truth."""
    data = tmp_path / "data"
    chip_smoke.write_sbd_tree(str(data / "sbd"), n_images=2, sizes=SIZES, seed=6,
                              max_instances=1, num_classes=2)
    imdb = pv.PascalVOCSeg("val", str(data / "sbd"), cache_dir=str(tmp_path / "cache"))
    segdb = chip_smoke.oracle_segdb(imdb, str(tmp_path / "segdb"))
    out = run_port_test_net(["--imdb", "voc_2012_seg_val", "--stages", "3", "--segdb", segdb,
                             "--seg-top-k", "8", "--set", *TEST_SET, "DATA_DIR", str(data)])
    assert "mAP^r@0.5 = 1.0000  mAP^r@0.7 = 1.0000" in out, out[-600:]
