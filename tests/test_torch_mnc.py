"""Port model pieces against the JAX package on the same params.

Params come from the JAX ``MNC.init`` (``PRNGKey(0)``), exported with
``save_npz`` and read back by the port's ``load_npz`` — the weight bridge
under test.  Everything runs in f32 on the CPU (the port's plain versions):

- weight bridge: every tensor lands, with HWIO→OIHW and (in, out)→(out, in);
- trunk and RPN head: ≤1e-4 of the output scale (13 f32 convs accumulate in
  different orders in XLA and oneDNN);
- ``propose_rois`` fed IDENTICAL RPN outputs (bf16-rounded, so many scores
  tie exactly): identical selections; boxes ≤1e-3 px (exp may round apart);
- the 21→14 soft-mask resize: ≤1e-6 against ``jax.image.resize``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.models.mnc import propose_rois as j_propose_rois
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch.models.mnc import MNC, MNCArch, linear_resize_matrix, propose_rois
from mnc_tpu_torch.utils.blob import device_normalize
from mnc_tpu_torch.utils.checkpoint import load_npz, state_dict_from_jax
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
             post_nms_top_n=16, rpn_min_size=4.0)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, **SMALL))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                     jnp.array([96.0, 128.0, 1.0]))
    path = str(tmp_path_factory.mktemp("npz") / "params.npz")
    save_npz(path, params, {"bbox_pred_normalized": False})
    loaded, meta = load_npz(path)
    model = MNC(MNCArch(compute_dtype=torch.float32, **SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(loaded))  # strict: every key lands
    return jm, params, model, meta


def _images(seed, b=2):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(b, 96, 128, 3)).astype(np.uint8)


def test_weight_bridge(bridged):
    _, params, model, meta = bridged
    assert meta == {"bbox_pred_normalized": False}
    p = params["params"]
    sd = model.state_dict()
    hwio = np.asarray(p["trunk"]["conv3_2"]["kernel"])
    np.testing.assert_array_equal(sd["trunk.conv3_2.weight"].numpy(), hwio.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["classify_head.fc6.weight"].numpy(),
                                  np.asarray(p["classify_head"]["fc6"]["kernel"]).T)
    np.testing.assert_array_equal(sd["rpn_head.rpn_cls_score.bias"].numpy(),
                                  np.asarray(p["rpn_head"]["rpn_cls_score"]["bias"]))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


def test_trunk_and_rpn_match_jax(bridged):
    jm, params, model, _ = bridged
    imgs = _images(0)
    jfeat = jm.apply(params, jnp.asarray(imgs), method=JMNC.features)
    jcls, jbox = jm.apply(params, jfeat, method=JMNC.rpn)
    feat = model.features(torch.from_numpy(imgs))
    cls, box = model.rpn_head(feat)
    for got, want in ((feat, jfeat), (cls, jcls), (box, jbox)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_device_normalize_matches_mean_subtraction():
    imgs = _images(1)
    from mnc_tpu_torch.config import cfg

    want = imgs.astype(np.float32) - np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(-1)
    np.testing.assert_array_equal(device_normalize(torch.from_numpy(imgs)).numpy(), want)
    f = torch.from_numpy(want)
    assert device_normalize(f) is f


@pytest.mark.parametrize("seed,suppress", [(0, True), (1, False)])
def test_propose_rois_identical_selections(seed, suppress):
    """Same RPN outputs in, same proposals out — including exact score ties
    (bf16-rounded logits), broken by lower anchor index as lax.top_k does."""
    kw = dict(SMALL, suppress_untrainable_anchors=suppress)
    jarch, arch = JArch(**kw), MNCArch(**kw)
    fh, fw = arch.feat_hw
    rs = np.random.RandomState(seed)
    cls = rs.randn(2, fh, fw, 2 * arch.num_anchors).astype(np.float32)
    cls = np.array(jnp.asarray(cls, jnp.bfloat16).astype(jnp.float32))
    box = (0.3 * rs.randn(2, fh, fw, 4 * arch.num_anchors)).astype(np.float32)
    info = np.array([[96.0, 128.0, 1.0], [70.0, 110.0, 0.8]], np.float32)
    anchors = arch.all_anchors()
    rois, valid, scores = propose_rois(torch.from_numpy(cls), torch.from_numpy(box),
                                       torch.from_numpy(info), torch.from_numpy(anchors),
                                       arch)
    for i in range(2):
        jr, jv, js = j_propose_rois(jnp.asarray(cls[i]), jnp.asarray(box[i]),
                                    jnp.asarray(info[i]), jnp.asarray(anchors), jarch)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(scores[i].numpy(), np.asarray(js))
        np.testing.assert_allclose(rois[i].numpy(), np.asarray(jr), rtol=0, atol=1e-3)


@pytest.mark.parametrize("nms_chunk", [1024, 64])
def test_propose_rois_golden(nms_chunk):
    g = np.load(os.path.join(GOLDEN, "proposal.npz"))
    min_size, pre_n, post_n, thresh = g["cfg"]
    arch = MNCArch(canvas=(128, 160), pre_nms_top_n=int(pre_n), post_nms_top_n=int(post_n),
                   rpn_nms_thresh=float(thresh), rpn_min_size=float(min_size),
                   suppress_untrainable_anchors=False, nms_chunk=nms_chunk)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    rois, valid, scores = propose_rois(t(g["logits"]), t(g["deltas"]), t(g["im_info"]),
                                       t(g["anchors"]), arch)
    n_ref = len(g["boxes"])
    assert int(valid.sum()) == n_ref
    np.testing.assert_allclose(rois[:n_ref].numpy(), g["boxes"], rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(scores[:n_ref].numpy(), g["scores"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(21, 14), (9, 4), (28, 14), (14, 21)])
def test_resize_matrix_matches_jax_image_resize(n_in, n_out):
    basis = jnp.eye(n_in, dtype=jnp.float32)
    want = np.asarray(jax.image.resize(basis, (n_in, n_out), method="linear"))  # (in, out)
    got = linear_resize_matrix(n_in, n_out)
    np.testing.assert_allclose(got.T, want, rtol=0, atol=1e-6)
    x = np.random.RandomState(n_in).uniform(size=(3, n_in, n_in)).astype(np.float32)
    want2 = np.asarray(jax.image.resize(jnp.asarray(x), (3, n_out, n_out), method="linear"))
    r = torch.from_numpy(got)
    np.testing.assert_allclose((r @ torch.from_numpy(x) @ r.T).numpy(), want2,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(n_stages=3), dict(test_bbox_reg=False)])
def test_three_stage_and_no_bridge_repeat_the_first_pass(bridged, kw):
    """3-stage: the outputs are the first pass.  TEST.BBOX_REG off: the
    second pass runs on the unrefined RoIs, so it repeats the first."""
    _, _, five, _ = bridged
    model = MNC(MNCArch(compute_dtype=torch.float32, **dict(SMALL, **kw)), device="cpu")
    model.load_state_dict(five.state_dict())
    imgs, infos = torch.from_numpy(_images(2)), torch.tensor([[96.0, 128.0, 1.0]] * 2)
    out, ref = model.apply_batch(imgs, infos), five.apply_batch(imgs, infos)
    torch.testing.assert_close(out["stage3_cls_prob"], ref["stage3_cls_prob"], rtol=0, atol=0)
    for key in ("rois", "cls_prob", "mask_logits"):
        torch.testing.assert_close(out[key], out[f"stage3_{key}"], rtol=0, atol=0)
    assert not torch.equal(ref["rois"], ref["stage3_rois"])  # the 5-stage bridge moved them


def test_dual_pathway_head_matches_jax():
    """``NET.DUAL_PATHWAY``: the raw RoI features are pooled beside the
    mask-pooled ones and concatenated after them before fc6, whose input is
    twice as wide.  The batched cascade on bridged weights: validity
    identical, boxes ≤1e-3 px, class probabilities ≤1e-5, mask logits and
    bbox deltas ≤1e-4 of their max."""
    kw = dict(SMALL, dual_pathway=True)
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, **kw))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((96, 128, 3), jnp.float32),
                     jnp.array([96.0, 128.0, 1.0]))
    model = MNC(MNCArch(compute_dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    assert model.classify_head.fc6.weight.shape == (64, 2 * 2 * 2 * 512)
    imgs, infos = _images(3), np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], np.float32)
    want = jax.jit(lambda p, i, f: jm.apply(p, i, f, method=JMNC.apply_batch))(
        params, jnp.asarray(imgs), jnp.asarray(infos))
    got = model.apply_batch(torch.from_numpy(imgs), torch.from_numpy(infos))
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["cls_prob"].numpy(), np.asarray(want["cls_prob"]), rtol=0,
                               atol=1e-5)
    for key in ("mask_logits", "bbox_pred", "stage3_mask_logits"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=key)
