"""Weight import of the port against the JAX package: the caffemodel reader
and writer (binary V1 / 1.0 and HDF5), the import of a fabricated
caffemodel with renamed layers, ``--remap`` and the mask-size auto-config
(``load_import_weights``), the npz export helpers (also against
``tests/fixtures/golden/snapshot.npz``), and the VGG-16 converters (caffe
npz, torchvision with the conv1_1 input adaptation).

Param trees and arch flags must be equal exactly (the same float32 values);
the imported weights must drive the port's cascade to the JAX package's
outputs (f32, tolerances of ``tests/test_torch_slice.py``), which holds the
fc layers' CHW → HWC reorder and the bridge's transpose together.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.utils import caffemodel as jcaffe
from mnc_tpu.utils import checkpoint as jckpt
from mnc_tpu.utils import weights as jweights
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.tools import fabricate_caffemodel as fab
from mnc_tpu_torch.utils import caffemodel, checkpoint, weights
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a small VGG-16 MNC (full trunk widths, narrow heads) whose layer shapes a
# fabricated caffemodel can carry
SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
             post_nms_top_n=16, rpn_min_size=4.0)
FAB = dict(num_classes=4, warp_hw=4, fc_dim=64, mask_fc_dim=32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_params(arch):
    return jax.device_get(JMNC(arch=arch).init(
        jax.random.PRNGKey(0), jnp.zeros((*arch.canvas, 3), jnp.float32),
        jnp.array([float(arch.canvas[0]), float(arch.canvas[1]), 1.0])))


def _port_params(arch):
    return checkpoint.jax_params_from_state_dict(
        MNC(arch, device="cpu", train=True).state_dict())


@pytest.fixture(scope="module")
def blobs():
    return fab.fabricate_blobs(mask_size=28, seed=5, **FAB)


@pytest.mark.parametrize("fmt", ["v1", "v2", "h5"])
def test_caffemodel_formats_round_trip_between_packages(tmp_path, blobs, fmt):
    """The port's writer is read back by both readers, and the JAX writer's
    file by the port's reader, blob for blob."""
    small = {k: blobs[k] for k in ("conv1_1", "rpn_conv/3x3", "fc6", "mask_pred")}
    ours, theirs = str(tmp_path / f"ours.{fmt}"), str(tmp_path / f"theirs.{fmt}")
    if fmt == "h5":
        caffemodel.write_caffemodel_h5(ours, small)
        jcaffe.write_caffemodel_h5(theirs, small)
    else:
        caffemodel.write_caffemodel(ours, small, v1=fmt == "v1")
        jcaffe.write_caffemodel(theirs, small, v1=fmt == "v1")
    for got in (caffemodel.read_caffemodel(ours), jcaffe.read_caffemodel(ours),
                caffemodel.read_caffemodel(theirs)):
        # binary files keep the layer order; HDF5 lists groups by name
        assert (sorted(got) if fmt == "h5" else list(got)) == (
            sorted(small) if fmt == "h5" else list(small))
        for name, arrs in small.items():
            for a, b in zip(got[name], arrs):
                np.testing.assert_array_equal(a, b)
    if fmt != "h5":
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()


def test_fabricated_blobs_equal_the_jax_tools(blobs):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from fabricate_caffemodel import fabricate_blobs, mnc_blob_shapes
    finally:
        sys.path.pop(0)
    assert fab.mnc_blob_shapes(mask_size=28) == mnc_blob_shapes(mask_size=28)
    want = fabricate_blobs(mask_size=28, seed=5, **FAB)
    assert list(blobs) == list(want)
    for name in want:
        for a, b in zip(blobs[name], want[name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["exact names", "renamed + remap", "renamed, shape-matched"])
def test_import_equals_jax_tree_and_arch(tmp_path, how):
    """load_import_weights of a fabricated file (mask size 28 → auto-config
    re-init) gives the JAX package's tree and arch flags, leaf for leaf."""
    path = str(tmp_path / "fab.caffemodel")
    rename, remap = [], None
    if how == "renamed + remap":  # the mask branch under other names
        rename = ["fc6_maskest=fc_mask_v2", "mask_pred=mask_score"]
        remap = ["fc_mask_v2=fc6_maskest", "mask_score=mask_pred"]
    elif how == "renamed, shape-matched":  # a unique shape finds its layer
        rename = ["fc6_maskest=fc_mask_v2"]
    blobs = fab.fabricate_blobs(mask_size=28, seed=1, **FAB)
    for pair in rename:
        old, new = pair.split("=")
        blobs[new] = blobs.pop(old)
    caffemodel.write_caffemodel(path, blobs)

    arch, jarch = MNCArch(compute_dtype=torch.float32, **SMALL), JArch(
        compute_dtype=jnp.float32, **SMALL)
    # mask size 28 is not SMALL's 9, so both re-initialize through make_params
    # and the trees passed in are not used
    got, got_arch = checkpoint.load_import_weights(path, None, arch, None, remap=remap,
                                                   make_params=_port_params)
    want, want_arch = jckpt.load_import_weights(path, None, jarch, None, remap=remap,
                                                make_params=_jax_params)
    assert_trees_equal(got, want)
    shared = ({f.name for f in dataclasses.fields(want_arch)}
              & {f.name for f in dataclasses.fields(got_arch)}) - {"compute_dtype"}
    assert len(shared) > 20
    for name in sorted(shared):
        assert getattr(got_arch, name) == getattr(want_arch, name), name
    assert (got_arch.mask_size, got_arch.bbox_pred_normalized,
            got_arch.suppress_untrainable_anchors) == (28, False, False)


def test_fabricate_cli_writes_both_formats(tmp_path, monkeypatch):
    """The CLI's --h5 and --rename, on narrow heads (the full-size shapes are
    held against the JAX tool by test_fabricated_blobs_equal_the_jax_tools)."""
    real = fab.fabricate_blobs
    monkeypatch.setattr(fab, "fabricate_blobs", lambda mask_size, num_classes, seed: real(
        mask_size=mask_size, num_classes=num_classes, seed=seed, warp_hw=4, fc_dim=64,
        mask_fc_dim=32))
    out, h5 = str(tmp_path / "a.caffemodel"), str(tmp_path / "a.h5")
    blobs = real(mask_size=21, num_classes=21, seed=0, warp_hw=4, fc_dim=64, mask_fc_dim=32)
    assert fab.main([out, "--h5", h5, "--mask-size", "21", "--rename",
                     "mask_pred=mask_score"]) == 0
    for path in (out, h5):
        got = caffemodel.read_caffemodel(path)
        assert "mask_score" in got and "mask_pred" not in got
        np.testing.assert_array_equal(got["fc6"][0], blobs["fc6"][0])
        np.testing.assert_array_equal(got["mask_score"][1], blobs["mask_pred"][1])
    assert caffemodel.infer_arch_overrides(caffemodel.read_caffemodel(h5)) == {
        "num_classes": 21, "fc_dim": 64, "mask_fc_dim": 32, "warp_hw": 4}


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A fabricated caffemodel imported by both packages into the small
    arch, and both cascades run on the same canvases."""
    path = str(tmp_path_factory.mktemp("caffe") / "fab.caffemodel")
    blobs = fab.fabricate_blobs(mask_size=9, seed=2, **FAB)
    # the fabricator's scale 0.01 leaves the trunk's output ~0: widen the
    # conv kernels so the heads see varied features
    for name in blobs:
        if name.startswith("conv"):
            blobs[name][0] = blobs[name][0] * 5.0
    caffemodel.write_caffemodel(path, blobs)
    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    jarch = JArch(compute_dtype=jnp.float32, roi_warp_impl="pallas", **SMALL)
    params, arch = checkpoint.load_import_weights(path, None, arch, _port_params(arch))
    jparams, jarch = jckpt.load_import_weights(path, None, jarch, _jax_params(jarch))
    model = MNC(arch, device="cpu")
    model.load_state_dict(checkpoint.state_dict_from_jax(params))
    rs = np.random.RandomState(4)
    imgs = rs.randint(0, 256, size=(2, 96, 128, 3)).astype(np.uint8)
    infos = np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], np.float32)
    jm = JMNC(arch=jarch)
    jout = jax.device_get(jax.jit(lambda p, i, f: jm.apply(p, i, f, method=JMNC.apply_batch))(
        jparams, jnp.asarray(imgs), jnp.asarray(infos)))
    out = model.apply_batch(torch.from_numpy(imgs), torch.from_numpy(infos))
    return arch, jout, {k: v.numpy() for k, v in out.items()}


def test_imported_caffemodel_drives_the_cascade_like_jax(imported):
    arch, jout, out = imported
    assert not arch.bbox_pred_normalized and not arch.suppress_untrainable_anchors
    np.testing.assert_array_equal(out["roi_valid"], jout["roi_valid"])
    assert jout["roi_valid"].any()
    np.testing.assert_allclose(out["rois"], jout["rois"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["cls_prob"], jout["cls_prob"], rtol=0, atol=1e-5)
    for key in ("mask_logits", "bbox_pred"):
        np.testing.assert_allclose(out[key], jout[key], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(jout[key]).max()))


def test_fc_reorder_is_chw_to_hwc():
    """The "fc" kind permutes caffe's CHW-flattened inputs to the HWC flatten
    both packages use; the bridge's transpose then gives nn.Linear's
    (out, in).  One input element, placed by hand, picks one weight."""
    c, hw, o = 512, 2, 3
    w = np.random.RandomState(0).randn(o, c * hw * hw).astype(np.float32)
    dst = {"kernel": np.zeros((hw * hw * c, o), np.float32)}
    got, err = caffemodel._convert_weight(w, "fc", dst)
    want, _ = jcaffe._convert_weight(w, "fc", dst)
    assert err is None
    np.testing.assert_array_equal(got, want)
    ch, y, x = 7, 1, 0
    x_hwc = np.zeros(hw * hw * c, np.float32)
    x_hwc[(y * hw + x) * c + ch] = 1.0
    lin = checkpoint.state_dict_from_jax({"fc": {"kernel": got}})["fc.weight"]
    np.testing.assert_array_equal(lin.numpy() @ x_hwc, w[:, ch * hw * hw + y * hw + x])


def test_export_and_renormalize_match_jax_and_golden():
    g = np.load(os.path.join(REPO, "tests", "fixtures", "golden", "snapshot.npz"))
    tree = {"params": {"classify_head": {"bbox_pred": {
        "kernel": g["kernel"].astype(np.float32), "bias": g["bias"].astype(np.float32)}}}}
    means, stds = tuple(g["means"]), tuple(g["stds"])
    folded = checkpoint.export_params(tree, means, stds)
    assert_trees_equal(folded, jckpt.export_params(tree, means, stds))
    bb = folded["params"]["classify_head"]["bbox_pred"]
    np.testing.assert_allclose(bb["kernel"], g["kernel_folded"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bb["bias"], g["bias_folded"], rtol=1e-5, atol=1e-6)
    back = checkpoint.renormalize_bbox_pred(folded, means, stds)
    assert_trees_equal(back, jckpt.renormalize_bbox_pred(folded, means, stds))
    np.testing.assert_allclose(back["params"]["classify_head"]["bbox_pred"]["kernel"],
                               g["kernel"], rtol=1e-4, atol=1e-5)
    # the input tree is not modified
    np.testing.assert_array_equal(tree["params"]["classify_head"]["bbox_pred"]["bias"],
                                  g["bias"].astype(np.float32))


@pytest.mark.parametrize("normalized", [True, False, None])
def test_npz_export_round_trips_through_both_packages(tmp_path, normalized):
    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    jarch = JArch(compute_dtype=jnp.float32, **SMALL)
    params = _port_params(arch)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    meta = {} if normalized is None else {"bbox_pred_normalized": normalized}
    checkpoint.save_npz(ours, params, meta)
    jckpt.save_npz(theirs, params, meta)
    for path in (ours, theirs):
        assert_trees_equal(checkpoint.load_npz(path)[0], jckpt.load_npz(path))
        assert checkpoint.npz_meta(path) == jckpt.npz_meta(path) == meta
        got = checkpoint.load_import_weights(None, path, arch, None)
        want = jckpt.load_import_weights(None, path, jarch, None)
        assert_trees_equal(got[0], want[0])
        assert got[1].bbox_pred_normalized == want[1].bbox_pred_normalized == (
            normalized is not False)


def test_train_state_npz_imports_its_params(tmp_path):
    """--npz also reads the port's train_net state: its params, not the
    solver's traces."""
    from mnc_tpu_torch.train.loop import TrainState
    from mnc_tpu_torch.train.optim import make_optimizer

    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    model = MNC(arch, device="cpu", train=True, seed=4)
    state = TrainState.create(model, make_optimizer(model))
    path = str(tmp_path / "state.npz")
    checkpoint.save_train_state(path, state)
    params, arch2 = checkpoint.load_import_weights(None, path, arch, None)
    assert set(params) == {"params"} and arch2.bbox_pred_normalized
    assert_trees_equal(params, checkpoint.jax_params_from_state_dict(model.state_dict()))
    jparams = jckpt.load_npz(path)
    assert_trees_equal(params, {"params": jparams["params"]})


def test_parse_remap():
    assert checkpoint.parse_remap(["a=b", "c=d=e"]) == jckpt.parse_remap(["a=b", "c=d=e"])
    assert checkpoint.parse_remap(None) == {}
    with pytest.raises(ValueError):
        checkpoint.parse_remap(["nopair"])


def _random_tv_state_dict(rs):
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
             (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
             (512, 512), (512, 512)]
    sd = {}
    for idx, (ci, co) in zip(weights._TV_FEATURE_IDX, chans):
        sd[f"features.{idx}.weight"] = torch.tensor(
            rs.randn(co, ci, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{idx}.bias"] = torch.tensor(rs.randn(co).astype(np.float32) * 0.05)
    return sd


def test_vgg16_caffe_npz_and_torchvision_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    params = _port_params(arch)
    arrays, prev = {}, 3
    for name in weights._VGG_CAFFE_NAMES:
        co = params["params"]["trunk"][name]["kernel"].shape[-1]
        arrays[f"{name}_w"] = rs.randn(co, prev, 3, 3).astype(np.float32)
        arrays[f"{name}_b"] = rs.randn(co).astype(np.float32)
        prev = co
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **arrays)
    assert_trees_equal(weights.load_vgg16_caffe_npz(path, params),
                       jweights.load_vgg16_caffe_npz(path, params))
    sd = _random_tv_state_dict(rs)
    got = weights.load_vgg16_torchvision(params, state_dict=sd)
    assert_trees_equal(got, jweights.load_vgg16_torchvision(params, state_dict=sd))
    np.testing.assert_array_equal(weights.caffe_conv_to_flax(arrays["conv1_1_w"]),
                                  jweights.caffe_conv_to_flax(arrays["conv1_1_w"]))

    # conv1_1 on BGR minus the pixel means = torchvision's on RGB/255, normalized
    from mnc_tpu_torch.config import cfg

    raw_bgr = rs.randint(0, 256, size=(16, 16, 3)).astype(np.float32)
    trunk = checkpoint.state_dict_from_jax(got)
    x = torch.from_numpy(raw_bgr - np.asarray(cfg.PIXEL_MEANS, np.float32)).permute(2, 0, 1)
    ours = torch.nn.functional.conv2d(x[None], trunk["trunk.conv1_1.weight"],
                                      trunk["trunk.conv1_1.bias"], padding=1)
    x_norm = (raw_bgr[..., ::-1] / 255.0 - weights._TV_MEAN) / weights._TV_STD
    xt = torch.tensor(np.transpose(x_norm, (2, 0, 1))[None].copy(), dtype=torch.float32)
    theirs = torch.nn.functional.conv2d(xt, sd["features.0.weight"], sd["features.0.bias"],
                                        padding=1)
    # exact on the interior; the zero padding differs at the 1-pixel border
    np.testing.assert_allclose(ours[0, :, 1:-1, 1:-1].numpy(),
                               theirs[0, :, 1:-1, 1:-1].numpy(), rtol=1e-4, atol=1e-4)
