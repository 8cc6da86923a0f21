"""The CFM path of the port (``mnc_tpu_torch/models/cfm.py``,
``train/targets.py::cfm_targets``, ``tools/{test_net,train_net} --segdb``)
against the JAX package (``mnc_tpu/models/cfm.py``, ``tools/test_net.py``),
at the small architecture of ``tests/test_cfm.py`` on the same weights
(``MNC.init`` with ``PRNGKey(0)``, bridged by ``state_dict_from_jax``) and
the same numpy-seeded inputs.  The JAX side warps through its plain
reference (the default ``roi_warp_impl`` on the CPU); its paste runs in f32
(``PostCfg(paste_dtype="f32")``), which is what the port always does.

Tolerances: selections (sampled RoIs and their masks, labels, matched gt,
valid flags, classes) identical; ``bbox_targets`` ≤ 1e-5; f32 ``cls_prob``
≤ 1e-5 and boxes ≤ 1e-3 px; the pseudo-logits ≤ 1e-4 (the clipped logit's
slope is 1/p(1-p)); scores ≤ 1e-5; canvas masks bit for bit except pixels
whose JAX f32 product lies within 1e-4 of the threshold; bf16 ``cls_prob``
≤ 2e-2 and boxes ≤ 0.5 px (bf16 keeps 8 bits: the trunk's rounding differs
between the packages).  The train step's tolerances are stated in
``tests/test_torch_cfm_train_step.py``.
"""

import contextlib
import io
import pickle
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models import cfm as jcfm
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.ops.masks import paste_masks as j_paste_masks
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.train import targets as JT
from mnc_tpu_torch import config as C
from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
from mnc_tpu_torch.models import cfm
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline.inference import PostCfg
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict, save_npz,
                                            state_dict_from_jax)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

ARCH_KW = dict(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
               warp_hw=4, n_stages=3, fc_dim=32, mask_fc_dim=16, pre_nms_top_n=32,
               post_nms_top_n=8, rpn_min_size=4.0)
INFO = np.array([64.0, 96.0, 1.0], np.float32)
POST = dict(dets_per_class=4, max_per_image=6, vote_top_k=8, score_thresh=0.0)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def jax_params():
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, **ARCH_KW))
    return jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((64, 96, 3), jnp.float32),
                            jnp.asarray(INFO))


def _models(params, dtype):
    jm = JMNC(arch=JArch(compute_dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype],
                         **ARCH_KW))
    model = MNC(MNCArch(compute_dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype],
                        **ARCH_KW), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jm, model


def _segments(seed, n, n_valid, s=9):
    """n boxes of 10-60 px inside the canvas, soft and binary masks, the
    first n_valid valid; the padding keeps zero boxes."""
    rs = np.random.RandomState(seed)
    xy = np.stack([rs.uniform(0, 40, n), rs.uniform(0, 30, n)], 1)
    wh = rs.uniform(10, 50, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [95, 63])], 1).astype(np.float32)
    masks = rs.uniform(size=(n, s, s)).astype(np.float32)
    masks[::2] = masks[::2] > 0.5
    valid = np.arange(n) < n_valid
    boxes[~valid], masks[~valid] = 0.0, 0.0
    image = rs.randn(64, 96, 3).astype(np.float32) * 40
    return image, boxes, masks, valid


# -------------------------------------------------------------------- apply


@pytest.mark.parametrize("s_in", [5, 9, 13, 21])
def test_mask_pseudo_logits_match(s_in):
    """jax.image.resize's antialiasing linear resize (down from 13 and 21,
    up from 5, identity at 9), clipped to logits."""
    rs = np.random.RandomState(s_in)
    masks = rs.uniform(size=(7, s_in, s_in)).astype(np.float32)
    masks[:3] = masks[:3] > 0.5
    want = np.asarray(jcfm.mask_pseudo_logits(jnp.asarray(masks), 9))
    got = cfm.mask_pseudo_logits(_t(masks), 9)
    assert got.dtype == torch.float32 and got.shape == (7, 9, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(torch.sigmoid(got).numpy(), 1 / (1 + np.exp(-want)), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def apply_cases(jax_params):
    """Both packages' cfm_apply on 16 segments (12 valid, masks at S = 13),
    with and without the box refinement, in f32 and in bf16."""
    image, boxes, masks, valid = _segments(1, 16, 12, s=13)
    out = {}
    for dtype in ("f32", "bf16"):
        jm, model = _models(jax_params, dtype)
        fn = jax.jit(lambda p, *a: [jcfm.cfm_apply(jm, p, *a, refine_boxes=r)
                                    for r in (True, False)])
        want = jax.tree_util.tree_map(np.asarray, fn(jax_params, image, INFO, boxes, masks,
                                                     valid))
        got = [{k: v.float().numpy() if v.is_floating_point() else v.numpy()
                for k, v in cfm.cfm_apply(model, *map(_t, (image, INFO, boxes, masks, valid)),
                                          refine_boxes=r).items()} for r in (True, False)]
        out[dtype] = got, want, boxes
    return out


@pytest.mark.parametrize("dtype,prob_tol,box_tol", [("f32", 1e-5, 1e-3), ("bf16", 2e-2, 0.5)])
def test_cfm_apply_matches(apply_cases, dtype, prob_tol, box_tol):
    got, want, boxes = apply_cases[dtype]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"cls_prob", "boxes", "masks", "valid"}
        assert g["cls_prob"].shape == (16, 4)
        np.testing.assert_allclose(g["cls_prob"], w["cls_prob"], rtol=0, atol=prob_tol)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=box_tol)
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["masks"], w["masks"])
    np.testing.assert_array_equal(got[1]["boxes"], boxes)  # unrefined: the input boxes
    assert np.abs(got[0]["boxes"] - boxes)[:12].max() > 0  # refined ones move


def test_cfm_apply_shapes_and_probs(jax_params):
    """``tests/test_cfm.py::test_cfm_apply_shapes_and_probs`` on the port."""
    _, model = _models(jax_params, "f32")
    rs = np.random.RandomState(0)
    n = 6
    boxes = np.stack([rs.uniform(0, 40, n), rs.uniform(0, 30, n), rs.uniform(50, 90, n),
                      rs.uniform(40, 60, n)], axis=1).astype(np.float32)
    masks = (rs.uniform(size=(n, 9, 9)) > 0.5).astype(np.float32)
    out = cfm.cfm_apply(model, _t(rs.randn(64, 96, 3).astype(np.float32)), _t(INFO),
                        _t(boxes), _t(masks), torch.ones(n, dtype=torch.bool))
    assert out["cls_prob"].shape == (n, 4)
    np.testing.assert_allclose(out["cls_prob"].sum(-1).numpy(), 1.0, atol=1e-3)
    b = out["boxes"].numpy()
    assert b.shape == (n, 4) and (b[:, 0] >= 0).all() and (b[:, 2] <= 95).all()


# ------------------------------------------------------------------- detect


@pytest.fixture(scope="module")
def detect_case(jax_params):
    """cfm_detect of both packages: the two segments of ``tests/test_cfm.py``
    (unrefined), and 24 random segments (20 valid, refined)."""
    jm, model = _models(jax_params, "f32")
    jpost = JPostCfg(paste_dtype="f32", **POST)
    boxes = np.array([[10, 10, 40, 40], [50, 20, 90, 60]] + [[0, 0, 0, 0]] * 6, np.float32)
    masks = np.concatenate([np.ones((2, 9, 9)), np.zeros((6, 9, 9))]).astype(np.float32)
    valid = np.arange(8) < 2
    zeros = np.zeros((64, 96, 3), np.float32)
    cases = [(zeros, boxes, masks, valid, False), (*_segments(2, 24, 20), True)]
    fn = jax.jit(lambda p, im, b, m, v, r: jcfm.cfm_detect(jm, p, im, INFO, b, m, v, jpost,
                                                            refine_boxes=r), static_argnums=5)
    want = [jax.tree_util.tree_map(np.asarray, fn(jax_params, *c)) for c in cases]
    got = [{k: v.numpy() for k, v in cfm.cfm_detect(model, im, INFO, b, m, v, PostCfg(**POST),
                                                   refine_boxes=r).items()}
           for im, b, m, v, r in cases]
    return got, want, boxes


def test_cfm_detect_matches(detect_case):
    got, want, _ = detect_case
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["valid"], w["valid"])
        assert w["valid"].any()
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["masks"], w["masks"], rtol=0, atol=1e-4)
        assert g["canvas_masks"].dtype == w["canvas_masks"].dtype == np.bool_
        prod = np.asarray(j_paste_masks(jnp.asarray(w["masks"]), jnp.asarray(w["boxes"]),
                                        ARCH_KW["canvas"], None))
        mism = g["canvas_masks"] != w["canvas_masks"]
        assert np.abs(prod[mism] - 0.4).max(initial=0.0) < 1e-4
    assert int(want[1]["valid"].sum()) > 2  # the random segments give many detections


def test_cfm_detect_end_to_end(detect_case):
    """``tests/test_cfm.py::test_cfm_detect_end_to_end`` on the port: every
    valid detection is one of the two segments; the pasted mask covers the
    box."""
    got, _, boxes = detect_case
    out = got[0]
    assert out["valid"].any()
    for b in out["boxes"][out["valid"]]:
        assert min(np.abs(b - boxes[0]).max(), np.abs(b - boxes[1]).max()) < 1e-3
    k = int(np.argmax(out["valid"]))
    assert out["canvas_masks"][k].sum() > 0.5 * 31 * 31


# ------------------------------------------------------------------ targets


def _uniforms(key, pool):
    """The draws JAX's cfm_targets makes from ``key``."""
    k_fg, k_bg = jax.random.split(key)
    return (_t(jax.random.uniform(k_fg, (pool,))), _t(jax.random.uniform(k_bg, (pool,))))


def _pool_case(seed, k=20, g=4):
    """k segments jittered around g gt instances and scattered, with soft
    masks; gt masks at S' = 12; two gt slots padding."""
    rs = np.random.RandomState(seed)
    gt_boxes = np.zeros((g, 4), np.float32)
    xy = rs.uniform(0, 50, (g - 2, 2))
    gt_boxes[:g - 2] = np.concatenate([xy, xy + rs.uniform(12, 40, (g - 2, 2))], 1)
    gt_valid = np.arange(g) < g - 2
    gt_classes = np.where(gt_valid, rs.randint(1, 4, g), 0).astype(np.int32)
    gt_masks = (rs.uniform(size=(g, 12, 12)) > 0.3).astype(np.float32)
    seg = np.concatenate([gt_boxes[rs.randint(0, g - 2, k // 2)]
                          + rs.uniform(-6, 6, (k // 2, 4)),
                          _segments(seed, k - k // 2, k - k // 2)[1]]).astype(np.float32)
    masks = (rs.uniform(size=(k, 9, 9)) > rs.uniform(0.1, 0.7, (k, 1, 1))).astype(np.float32)
    valid = rs.uniform(size=k) > 0.15
    return seg, masks, valid, gt_boxes, gt_classes, gt_valid, gt_masks


@pytest.mark.parametrize("iou_mode", ["box", "mask"])
@pytest.mark.parametrize("roi_batch", [32, 16], ids=["padded-pool", "full-pool"])
def test_cfm_targets_match(iou_mode, roi_batch):
    """20 segments + 4 gt slots: a pool of 24, padded to 32 RoIs or sampled
    down to 16, labelled by box or mask IoU, on JAX's own draws."""
    case = _pool_case(3)
    key = jax.random.PRNGKey(11)
    kw = dict(roi_batch=roi_batch, fg_fraction=0.5, fg_thresh=0.5, bg_thresh_hi=0.5,
              bg_thresh_lo=0.0, iou_mode=iou_mode)
    want = JT.cfm_targets(*map(jnp.asarray, case), key, **kw)
    pool = T.cfm_pool_size(20, 4, roi_batch)
    assert pool == max(24, roi_batch)
    got = T.cfm_targets(*map(_t, case), _uniforms(key, pool), **kw)
    assert got.rois.shape == (roi_batch, 4) and got.seg_masks.shape == (roi_batch, 9, 9)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    labels = np.asarray(want.labels)
    assert (labels > 0).any() and (labels == 0).any()
    assert (labels == -1).any() == (roi_batch == 32)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_array_equal(got.seg_masks.numpy(), np.asarray(want.seg_masks))
    np.testing.assert_array_equal(got.bbox_weight.numpy(), np.asarray(want.bbox_weight))
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("iou_mode", ["box", "mask"])
def test_assignment_matches(iou_mode):
    """The matched gt of every pool entry (the index cfm_targets gathers the
    class and the box target by), and its IoU."""
    seg, masks, valid, gt_boxes, gt_classes, gt_valid, gt_masks = _pool_case(5)
    if iou_mode == "mask":
        want = JT._assign_mask_iou(*map(jnp.asarray, (seg, masks, gt_boxes, gt_classes,
                                                      gt_valid, gt_masks)), 0.5)
        got = T._assign_mask_iou(*map(_t, (seg, masks, gt_boxes, gt_classes, gt_valid,
                                           gt_masks)), 0.5)
    else:
        want = JT._assign(*map(jnp.asarray, (seg, gt_boxes, gt_classes, gt_valid)), 0.5)
        got = T._assign(*map(_t, (seg, gt_boxes, gt_classes, gt_valid)), 0.5)
    max_ov, arg, mboxes, mcls, fg = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), max_ov, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), arg)
    np.testing.assert_array_equal(got[2].numpy(), mboxes)
    np.testing.assert_array_equal(got[3].numpy(), mcls)
    np.testing.assert_array_equal(got[4].numpy(), fg)
    assert fg.any() and (max_ov > 0).any()


def _same_targets(got, want):
    for name in ("rois", "labels", "bbox_weight", "seg_masks"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=0, atol=1e-5)


def test_cfm_targets_semantics():
    """``tests/test_cfm.py::test_cfm_targets_semantics`` on the port, and the
    JAX package's targets on the same inputs and its own draws."""
    args = (np.array([[10.0, 10.0, 29.0, 29.0], [12.0, 12.0, 31.0, 31.0],
                      [70.0, 40.0, 89.0, 59.0], [0.0, 0.0, 0.0, 0.0]], np.float32),
            np.full((4, 9, 9), 0.5, np.float32), np.array([True, True, True, False]),
            np.array([[10.0, 10.0, 29.0, 29.0], [40.0, 5.0, 59.0, 24.0]], np.float32),
            np.array([2, 3], np.int32), np.ones(2, bool), np.ones((2, 9, 9), np.float32))
    key = jax.random.PRNGKey(0)
    tgt = T.cfm_targets(*map(_t, args), _uniforms(key, 8), roi_batch=8, fg_fraction=1.0)
    _same_targets(tgt, JT.cfm_targets(*map(jnp.asarray, args), key, roi_batch=8,
                                      fg_fraction=1.0))
    labels, rois = tgt.labels.numpy(), tgt.rois.numpy()
    assert sorted(labels[labels > 0].tolist()) == [2, 2, 2, 3]
    assert any(np.allclose(r, [70, 40, 89, 59]) for r in rois[labels == 0])
    w = tgt.bbox_weight.numpy()
    assert set(w[labels > 0]) == {1.0} and set(w[labels <= 0]) == {0.0}
    exact = np.where([np.allclose(r, [10, 10, 29, 29]) for r in rois])[0]
    np.testing.assert_allclose(tgt.bbox_targets.numpy()[exact[0]], 0.0, atol=1e-5)
    gt_rows = [i for i, r in enumerate(rois) if np.allclose(r, [40, 5, 59, 24])]
    assert gt_rows and np.allclose(tgt.seg_masks.numpy()[gt_rows[0]], 1.0)


def test_cfm_targets_mask_iou_mode():
    """``tests/test_cfm.py::test_cfm_targets_mask_iou_mode`` on the port, and
    against the JAX package: two segments on the gt box, one with the gt's
    full mask and one a sliver; mask IoU labels them fg and bg, box IoU
    cannot tell them apart."""
    sliver = np.zeros((9, 9), np.float32)
    sliver[:, :1] = 1.0
    args = (np.array([[10.0, 10.0, 29.0, 29.0]] * 2, np.float32),
            np.stack([np.ones((9, 9), np.float32), sliver]), np.ones(2, bool),
            np.array([[10.0, 10.0, 29.0, 29.0]], np.float32), np.array([2], np.int32),
            np.ones(1, bool), np.ones((1, 9, 9), np.float32))
    key = jax.random.PRNGKey(0)
    for mode, sliver_label in (("mask", 0), ("box", 2)):
        tgt = T.cfm_targets(*map(_t, args), _uniforms(key, 8), roi_batch=8, fg_fraction=1.0,
                            iou_mode=mode)
        _same_targets(tgt, JT.cfm_targets(*map(jnp.asarray, args), key, roi_batch=8,
                                          fg_fraction=1.0, iou_mode=mode))
        labels, m = tgt.labels.numpy(), tgt.seg_masks.numpy()
        rows = [i for i in range(8) if np.isclose(m[i].mean(), 1 / 9, atol=1e-3)]
        assert rows and all(labels[i] == sliver_label for i in rows)
        full_rows = [i for i in range(8) if np.isclose(m[i].mean(), 1.0) and labels[i] >= 0]
        assert full_rows and all(labels[i] == 2 for i in full_rows)


# -------------------------------------------------------------------- tools


def _oracle_npz(path):
    """Weights that make the classify head a shape oracle for the synthetic
    imdb, whose class is the instance's shape (rectangle, ellipse, triangle,
    cross, diamond, filling its box): the trunk outputs ones (every kernel
    0, conv5_3's bias 1), so mask pooling hands fc6 the segment's own mask
    at 14 x 14, max-pooled to 7 x 7; fc6 scores it against each shape's
    template (t·x - |t|²/2, nearest in L2), fc7 passes those scores on, and
    cls_score turns them into near-certain probabilities; bbox_pred is 0."""
    from mnc_tpu_torch.data.synthetic import _render_shape
    from mnc_tpu_torch.models.mnc import linear_resize_matrix
    from mnc_tpu_torch.utils.blob import resize_mask_area

    arch = MNCArch(canvas=(128, 160), num_classes=6, anchor_scales=(2, 4, 8), fc_dim=64,
                   mask_fc_dim=32, compute_dtype=torch.float32)
    sd = MNC(arch, device="cpu", seed=1, train=True).state_dict()
    for k, v in sd.items():
        if k.startswith(("trunk.", "classify_head.")):
            v.zero_()
    sd["trunk.conv5_3.bias"].fill_(1.0)
    r = linear_resize_matrix(21, 14)
    for c in range(5):
        m = np.clip(resize_mask_area(_render_shape(c, 28, 28), (21, 21)), 1e-4, 1 - 1e-4)
        t = (r @ m @ r.T).reshape(7, 2, 7, 2).max(axis=(1, 3))
        sd["classify_head.fc6.weight"][c].view(7, 7, 512)[..., 0] = torch.from_numpy(t)
        sd["classify_head.fc6.bias"][c] = 50.0 - 0.5 * float((t ** 2).sum())
        sd["classify_head.fc7.weight"][c, c] = 1.0
        sd["classify_head.cls_score.weight"][c + 1, c] = 10.0
    sd["classify_head.cls_score.bias"][0] = 470.0  # background below every shape's score
    save_npz(str(path), jax_params_from_state_dict(sd), {"bbox_pred_normalized": True})


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """synthetic_8's own gt boxes and masks as its segdb, and the shape
    oracle's weights."""
    root = tmp_path_factory.mktemp("oracle")
    imdb = SyntheticIMDB(num_images=8)
    for i, (entry, masks) in enumerate(zip(imdb.roidb(), imdb.maskdb())):
        with open(root / f"{i}.pkl", "wb") as f:
            pickle.dump({"index": i, "boxes": entry["boxes"], "masks": masks["masks"]}, f)
    _oracle_npz(root / "oracle.npz")
    return root


SMALL_SET = ["--set", "NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE",
             "float32"]


@contextlib.contextmanager
def _cfg_restored():
    saved = C.cfg.clone()
    try:
        yield
    finally:
        C.cfg.clear()
        C.cfg.update(saved)


def _ap_table(text):
    lines = text.splitlines()
    return lines[next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~")):]


def test_test_net_segdb_oracle_scores_one_like_the_jax_tool(oracle, monkeypatch):
    """``test_net --segdb`` on synthetic_8 with oracle segments: mAP^r 1.0,
    and the JAX tool prints the same AP table on the same files."""
    from mnc_tpu_torch.tools import test_net

    argv = ["--imdb", "synthetic_8", "--npz", str(oracle / "oracle.npz"), "--segdb",
            str(oracle), *SMALL_SET]
    buf = io.StringIO()
    with _cfg_restored(), contextlib.redirect_stdout(buf):
        assert test_net.main([*argv, "--device", "cpu"]) == 0
    got = _ap_table(buf.getvalue())
    assert got[-1] == "mAP^r@0.5 = 1.0000  mAP^r@0.7 = 1.0000"

    from mnc_tpu.config import cfg as jcfg

    monkeypatch.setattr(sys, "argv", ["test_net.py", "--cpu", *argv])
    monkeypatch.syspath_prepend("tools")
    saved = jcfg.clone()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path("tools/test_net.py", run_name="__main__")
    finally:
        jcfg.clear()
        jcfg.update(saved)
    assert _ap_table(buf.getvalue()) == got


TRAIN_SET = [*SMALL_SET, "NET.N_STAGES", "3", "TRAIN.BATCH_SIZE", "32",
             "TRAIN.SNAPSHOT_ITERS", "1"]


def test_train_net_segdb_steps_snapshots_and_resumes(oracle, tmp_path):
    """``train_net --segdb --device cpu``: 2 CFM steps through TrainLoader,
    a snapshot after each; a run resumed from the first snapshot ends with
    the same parameters and solver state as the uninterrupted one; without
    ``--device cpu`` it raises here."""
    from mnc_tpu_torch.tools import train_net
    from mnc_tpu_torch.utils.checkpoint import checkpoint_npz

    argv = ["--imdb", "synthetic_8", "--iters", "2", "--segdb", str(oracle), "--seg-top-k",
            "8", "--print-every", "1", *TRAIN_SET]
    with _cfg_restored(), pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main([*argv, "--out", str(tmp_path / "gpu")])
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    with _cfg_restored():
        assert train_net.main([*argv, "--device", "cpu", "--out", str(full)]) == 0
    for step in (1, 2):
        assert (full / f"ckpt_{step:08d}" / "train_state.npz").exists()
    lines = (full / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all('"cfm_cls"' in ln and '"cfm_bbox"' in ln for ln in lines)
    resumed.mkdir()
    (full / "ckpt_00000001").rename(resumed / "ckpt_00000001")
    buf = io.StringIO()
    with _cfg_restored(), contextlib.redirect_stdout(buf):
        assert train_net.main([*argv, "--device", "cpu", "--out", str(resumed)]) == 0
    assert "resumed from iter 1" in buf.getvalue()
    a = np.load(checkpoint_npz(str(full)))
    b = np.load(checkpoint_npz(str(resumed)))
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
