"""``TEST.INT8`` on the ResNet family, the int8 audit and the entry points,
on the CPU; the quantizers, the layers and the VGG-16 cascade are in
``tests/test_torch_quant.py``, whose notes on the reference hold here: the
JAX code is evaluated op by op (outside ``jit``), where its arithmetic is
the source's.

- The ResNet-50 int8 trunk (the 7×7/s2 stem, 1×1 and 3×3 at stride 1 and
  2, the projections; random FrozenBN leaves as in
  ``tests/test_torch_resnet.py``): bit-identical to JAX's in f32 and bf16.
- The int8 conv5 head at a small width (6 RoIs of 4×4×64, one activation
  scale over all of them): its float tail (the spatial mean, ``cls_score``
  and ``bbox_pred``) sums in other orders, so the logits are held within
  1e-5 (f32) and one bf16 ulp, 2^-7 (bf16), of their max.
- ``mnc_tpu_torch.tools.int8_audit`` against ``tools/int8_audit.py --cpu``
  on the same weights and image.  The JAX tool runs under ``jit``, whose
  int8 trunk differs from the op-by-op one by an int8 step here and there
  (see the note), and both float paths sum in other orders: the trunk
  error and the head-isolation statistics (the same float features and
  RoIs on both sides) are held within 2e-3 absolute; the statistics taken
  on each path's own proposals (RPN logits, best IoU, end-to-end), which a
  reordering of near-tied proposals moves, within 0.01, and the share of
  identical proposals within 0.05.
- ``serve``, ``test_net`` and ``demo`` with ``--set TEST.INT8 True``.
"""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.models.resnet import ConvRoIHead as JConvRoIHead
from mnc_tpu.models.resnet import ResNetTrunk as JResNetTrunk
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch.models.resnet import ConvRoIHead, ResNetTrunk
from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_torch_quant import DTYPES, _np, _t
from tests.test_torch_resnet import randomize_bn
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def port_cfg_restored():
    saved = pconfig.cfg.clone()
    try:
        yield
    finally:
        pconfig.cfg.clear()
        pconfig.cfg.update(saved)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resnet50_trunk_int8_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(6)
    x = (rs.randn(1, 64, 96, 3) * 40).astype(np.float32)
    jt = JResNetTrunk(depth=50, compute_dtype=jdt, int8=True)
    params = randomize_bn({"params": jax.jit(jt.init)(jax.random.PRNGKey(0), x)["params"]}, rs)
    want = _np(jt.apply(params, jnp.asarray(x)))
    trunk = ResNetTrunk(50, tdt, int8=True)
    trunk.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = _t(trunk(torch.from_numpy(x)))
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_roi_head_int8_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(7)
    feat = (rs.randn(6, 4, 4, 64) * 2).astype(np.float32)
    soft = rs.rand(6, 4, 4).astype(np.float32)
    jh = JConvRoIHead(num_classes=4, depth=50, compute_dtype=jdt, int8=True)
    params = randomize_bn({"params": jax.jit(jh.init)(jax.random.PRNGKey(0), feat,
                                                      soft)["params"]}, rs)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rs.randn(*a.shape).astype(np.float32) * 0.01), params)
    want = [np.asarray(a) for a in jh.apply(params, jnp.asarray(feat), jnp.asarray(soft))]
    head = ConvRoIHead(4, 50, 64, tdt, int8=True)
    head.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = [t.numpy() for t in head(torch.from_numpy(feat), torch.from_numpy(soft))]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())


# the JAX tool's --cpu cascade, as cfg keys of the port
AUDIT_SET = ["STATIC.CANVAS", "(128, 192)", "NET.ANCHOR_SCALES", "(2, 4, 8)",
             "NET.NUM_CLASSES", "6", "MASK_SIZE", "9", "NET.WARP_HW", "4", "NET.FC_DIM", "128",
             "NET.MASK_FC_DIM", "32", "STATIC.TEST_PRE_NMS_TOP_N", "128",
             "STATIC.TEST_POST_NMS_TOP_N", "32", "TEST.RPN_MIN_SIZE", "4",
             "NET.COMPUTE_DTYPE", "float32"]


def test_int8_audit_matches_the_jax_tool(tmp_path):
    from mnc_tpu_torch.tools import int8_audit

    base = JArch(canvas=(128, 192), anchor_scales=(2, 4, 8), num_classes=6, mask_size=9,
                 warp_hw=4, n_stages=5, fc_dim=128, mask_fc_dim=32, pre_nms_top_n=128,
                 post_nms_top_n=32, rpn_min_size=4.0, trunk_frozen=0,
                 compute_dtype=jnp.float32)
    # the params the JAX tool draws for itself (PRNGKey(0)), as an npz
    params = jax.jit(JMNC(arch=base).init)(jax.random.PRNGKey(0),
                                           jnp.zeros((128, 192, 3), jnp.float32),
                                           jnp.array([128.0, 192.0, 1.0]))
    npz = str(tmp_path / "audit.npz")
    save_npz(npz, params, {"bbox_pred_normalized": True})
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import int8_audit as jaudit
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    argv = sys.argv
    try:
        sys.argv = ["int8_audit.py", "--cpu", "--images", "1"]
        with contextlib.redirect_stdout(buf):
            jaudit.main()
    finally:
        sys.argv = argv
    with port_cfg_restored(), contextlib.redirect_stdout(buf), pytest.warns(UserWarning,
                                                                           match="CAPPED"):
        assert int8_audit.main(["--params", npz, "--device", "cpu", "--images", "1",
                                "--set", *AUDIT_SET]) == 0
    want, got = (json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{"))
    assert set(got) == set(want) and got["n_images"] == want["n_images"] == 1
    assert got["proposal_identical_frac"] == pytest.approx(want["proposal_identical_frac"],
                                                           abs=0.05)
    same_inputs = ("trunk_feat_rel_err", "heads_only_cls_prob_absdiff",
                   "heads_only_mask_prob_absdiff")
    for key, w in want.items():
        if isinstance(w, dict):
            tol = 2e-3 if key in same_inputs else 0.01
            for stat, v in w.items():
                assert abs(got[key][stat] - v) <= tol, (key, stat, got[key][stat], v)


SET = ["STATIC.CANVAS", "(64, 96)", "NET.ANCHOR_SCALES", "(1, 2, 4)", "NET.NUM_CLASSES", "4",
       "MASK_SIZE", "9", "NET.WARP_HW", "4", "NET.FC_DIM", "32", "NET.MASK_FC_DIM", "16",
       "NET.COMPUTE_DTYPE", "float32", "STATIC.TEST_PRE_NMS_TOP_N", "32",
       "STATIC.TEST_POST_NMS_TOP_N", "8", "TEST.RPN_MIN_SIZE", "2", "TEST.SCALES", "(48,)",
       "TEST.MAX_SIZE", "96", "TEST.PASTE_DTYPE", "f32"]


def test_serve_runs_int8(tmp_path, capsys):
    """``serve --set TEST.INT8 True``: one JSON line per image, the lines of
    the int8 pipeline that ``load_pipeline`` builds (its layers int8)."""
    from mnc_tpu_torch.ops.quant import ConvInt8, DenseInt8
    from mnc_tpu_torch.tools import serve

    rs = np.random.RandomState(2)
    images = [(rs.rand(60, 120, 3) * 255).astype(np.uint8),
              (rs.rand(48, 96, 3) * 255).astype(np.uint8)]
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"im{i}.npy"))
        np.save(paths[-1], im)
    argv = ["--device", "cpu", "--conf", "0.0", "--set", *SET, "TEST.INT8", "True"]
    with port_cfg_restored(), pytest.warns(UserWarning, match="CAPPED"):
        pipe = serve.load_pipeline(serve.parse_args(argv))
    assert pipe.model.arch.int8_inference
    assert isinstance(pipe.model.trunk.conv4_2, ConvInt8)
    assert isinstance(pipe.model.classify_head.fc7, DenseInt8)
    capsys.readouterr()
    with port_cfg_restored(), pytest.warns(UserWarning, match="CAPPED"):
        assert serve.main([*paths, *argv]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["image"] for ln in lines] == paths
    for ln, im in zip(lines, images):
        assert ln["instances"] == serve.dets_to_json(pipe.detect(im), 0.0)["instances"]
        assert ln["instances"]


SMALL_CFG = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32",
             "TEST.INT8", "True"]


def test_test_net_and_demo_run_int8(tmp_path):
    from mnc_tpu_torch.tools import demo, test_net

    buf = io.StringIO()
    with port_cfg_restored(), contextlib.redirect_stdout(buf):
        assert test_net.main(["--imdb", "synthetic_4", "--device", "cpu", "--eval-batch",
                              "2", "--set", *SMALL_CFG]) == 0
    assert "mAP^r@0.5 = " in buf.getvalue()
    with port_cfg_restored(), contextlib.redirect_stdout(buf):
        assert demo.main(["--synthetic", "--device", "cpu", "--out", str(tmp_path),
                          "--stages", "3", "--set", *SMALL_CFG, "STATIC.CANVAS", "[96, 128]",
                          "STATIC.TEST_PRE_NMS_TOP_N", "256",
                          "STATIC.TEST_POST_NMS_TOP_N", "64"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"synthetic_{i}.png"
                                                          for i in range(4)]
