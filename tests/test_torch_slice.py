"""The whole serving slice of the port against the JAX package, on the same
params and the same canvases: ``apply_batch`` + ``vote_candidates`` +
``postprocess_detections`` at B=2 on ``tests/test_pipeline.py``'s small
architecture, f32, with the JAX side on its Pallas kernels (interpret mode:
``roi_warp_impl="pallas"``, ``PostCfg(paste_impl="pallas",
paste_dtype="f32")``) and the port on its plain versions.

Tolerances: selections (valid, classes, roi indices through the boxes)
identical; boxes ≤1e-3 px; scores ≤1e-5; soft masks ≤1e-4; canvas masks bit
for bit except pixels whose JAX f32 product lies within 1e-4 of the
threshold (the soft masks themselves may differ by that much).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.ops.masks import paste_masks as j_paste_masks
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.pipeline.inference import postprocess_detections as j_postprocess
from mnc_tpu.pipeline.inference import vote_candidates as j_vote_candidates
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg, postprocess_detections
from mnc_tpu_torch.pipeline.inference import vote_candidates
from mnc_tpu_torch.utils.checkpoint import load_npz, state_dict_from_jax
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
             post_nms_top_n=16, rpn_min_size=4.0)
POST = dict(dets_per_class=4, max_per_image=8)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, roi_warp_impl="pallas", **SMALL))
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, size=(2, 96, 128, 3)).astype(np.uint8)
    infos = np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                     jnp.asarray(infos[0]))
    path = str(tmp_path_factory.mktemp("npz") / "params.npz")
    save_npz(path, params, {"bbox_pred_normalized": True})
    model = MNC(MNCArch(compute_dtype=torch.float32, **SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(load_npz(path)[0]))

    jpost = JPostCfg(paste_impl="pallas", paste_dtype="f32", **POST)
    jnet = jax.jit(lambda p, i, f: jm.apply(p, i, f, method=JMNC.apply_batch))(
        params, jnp.asarray(imgs), jnp.asarray(infos))
    r, v, c, m = j_vote_candidates(jnet, jpost, 5, axis=1)
    jdet = jax.jit(jax.vmap(lambda *a: j_postprocess(*a, jpost, SMALL["canvas"])))(
        r, v, c, m)
    jdet = jax.tree_util.tree_map(np.asarray, jdet)
    jnet = jax.tree_util.tree_map(np.asarray, jnet)

    net = model.apply_batch(torch.from_numpy(imgs), torch.from_numpy(infos))
    post = PostCfg(**POST)
    det = postprocess_detections(*vote_candidates(net, post, 5, axis=1), post,
                                 SMALL["canvas"])
    served = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    return jnet, jdet, net, det, served


def test_cascade_outputs_match(both):
    jnet, _, net, _, _ = both
    assert set(net) == set(jnet)
    np.testing.assert_array_equal(net["roi_valid"].numpy(), jnet["roi_valid"])
    for key in ("rois", "stage3_rois"):
        np.testing.assert_allclose(net[key].numpy(), jnet[key], rtol=0, atol=1e-3)
    for key in ("cls_prob", "stage3_cls_prob"):
        np.testing.assert_allclose(net[key].numpy(), jnet[key], rtol=0, atol=1e-5)
    for key in ("mask_logits", "stage3_mask_logits", "bbox_pred"):
        np.testing.assert_allclose(net[key].numpy(), jnet[key], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(jnet[key]).max()))


def test_detections_match(both):
    _, jdet, _, det, _ = both
    assert set(det) == set(jdet)
    np.testing.assert_array_equal(det["valid"].numpy(), jdet["valid"])
    assert jdet["valid"].any()
    np.testing.assert_array_equal(det["classes"].numpy(), jdet["classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), jdet["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det["scores"].numpy(), jdet["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(det["masks"].numpy(), jdet["masks"], rtol=0, atol=1e-4)


def test_canvas_masks_match(both):
    _, jdet, _, det, _ = both
    got, want = det["canvas_masks"].numpy(), jdet["canvas_masks"]
    assert got.dtype == want.dtype == np.bool_ and got.shape == want.shape
    prod = np.stack([np.asarray(j_paste_masks(jnp.asarray(jdet["masks"][i]),
                                              jnp.asarray(jdet["boxes"][i]),
                                              SMALL["canvas"], None)) for i in range(2)])
    mism = got != want
    assert np.abs(prod[mism] - 0.4).max(initial=0.0) < 1e-4
    assert mism.mean() < 1e-3


def test_pipeline_entry_point_matches(both):
    """MNCPipeline.detect_canvas_batch (numpy in) = the functions composed."""
    _, _, _, det, served = both
    for key, v in det.items():
        np.testing.assert_array_equal(served[key].numpy(), v.numpy())


def _net_out(seed, b=2, n=32, c=4, m=9):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 80, size=(2, b, n, 2)).astype(np.float32)
    rois = np.concatenate([xy[0], xy[0] + rs.uniform(8, 48, (b, n, 2))], -1)
    rois = rois.astype(np.float32)
    prob = rs.dirichlet(np.ones(c), size=(2, b, n)).astype(np.float32)
    logits = rs.randn(2, b, n, m, m).astype(np.float32)
    valid = rs.uniform(size=(b, n)) > 0.2
    return {"rois": rois, "roi_valid": valid, "cls_prob": prob[0],
            "mask_logits": logits[0], "stage3_rois": rois[:, ::-1].copy(),
            "stage3_cls_prob": prob[1], "stage3_mask_logits": logits[1]}


@pytest.mark.parametrize("opts", [
    dict(vote_boxes=True),
    dict(use_mask_merge=False, score_thresh=0.2),
    dict(vote_both_passes=True, nms_thresh=0.5, vote_top_k=8),
])
def test_postprocess_options_match_jax(opts):
    """The PostCfg variants off the serving defaults, on the same candidates."""
    net = _net_out(sum(map(len, opts)))
    jpost = JPostCfg(paste_impl="pallas", paste_dtype="f32", **POST, **opts)
    r, v, c, m = j_vote_candidates({k: jnp.asarray(x) for k, x in net.items()}, jpost, 5,
                                   axis=1)
    want = jax.jit(jax.vmap(lambda *a: j_postprocess(*a, jpost, SMALL["canvas"])))(
        r, v, c, m)
    post = PostCfg(**POST, **opts)
    got = postprocess_detections(*vote_candidates(
        {k: torch.from_numpy(x) for k, x in net.items()}, post, 5, axis=1), post,
        SMALL["canvas"])
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key, tol in (("boxes", 1e-4), ("scores", 1e-6), ("masks", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=tol)
    mism = got["canvas_masks"].numpy() != np.asarray(want["canvas_masks"])
    assert mism.mean() < 1e-4
