"""The ResNet cascade as a whole against the JAX package: ``apply_batch`` and
``MNCPipeline.detect_canvas_batch`` against ``MNC.apply_batch`` and
``postprocess_detections``, with the per-RoI conv5 head and with the fc head,
3- and 5-stage, on the same weights (random FrozenBN leaves, see
``tests/test_torch_resnet.py``) and the same canvases, at the small ResNet-50
architecture of ``tests/test_resnet.py``.  The JAX side runs its Pallas
kernels in interpret mode (``roi_warp_impl="pallas"``, ``PostCfg(
paste_impl="pallas", paste_dtype="f32")``), the port its plain versions.

Tolerances in f32, those of ``tests/test_torch_slice.py``: selections
(validity, classes, and through the boxes the RoI indices) identical; boxes
≤1e-3 px; scores and class probabilities ≤1e-5; mask logits and bbox deltas
≤1e-4 of their max; soft masks ≤1e-4; canvas masks bit for bit except
pixels whose JAX f32 product lies within 1e-4 of the threshold.

The bf16 case holds what can be held when two libraries round some 50 bf16
convolutions each in their own order: the trunk's features and the RPN
outputs within 2% of their max (measured 0.56%, 0.46% and 0.51%) and, on
the RoIs that JAX proposed, the first pass's mask logits within 2% of their
max (measured 0.60%) and its class probabilities within 0.01 (measured
0.00075); selections are not compared, since scores that close may reorder.
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
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg, postprocess_detections
from mnc_tpu_torch.pipeline.inference import vote_candidates
from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_torch_resnet import SMALL, randomize_bn
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

POST = dict(dets_per_class=4, max_per_image=8)
CASES = [(True, 5), (True, 3), (False, 5), (False, 3)]


def _inputs():
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, size=(2, 64, 96, 3)).astype(np.uint8)
    infos = np.array([[64.0, 96.0, 1.0], [56.0, 90.0, 1.0]], np.float32)
    return imgs, infos


def _models(roi_conv5, n_stages, jdtype, tdtype):
    kw = dict(SMALL, roi_conv5=roi_conv5, n_stages=n_stages)
    jm = JMNC(arch=JArch(compute_dtype=jdtype, roi_warp_impl="pallas", **kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((64, 96, 3), jnp.float32),
                              jnp.array([64.0, 96.0, 1.0]))
    params = randomize_bn({"params": params["params"]}, np.random.RandomState(11))
    model = MNC(MNCArch(compute_dtype=tdtype, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jm, params, model


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{'conv5' if c else 'fc'}-{s}stage" for c, s in CASES])
def both(request):
    roi_conv5, n_stages = request.param
    jm, params, model = _models(roi_conv5, n_stages, jnp.float32, torch.float32)
    imgs, infos = _inputs()
    jpost = JPostCfg(paste_impl="pallas", paste_dtype="f32", **POST)
    jnet = jax.jit(lambda p, i, f: jm.apply(p, i, f, method=JMNC.apply_batch))(
        params, jnp.asarray(imgs), jnp.asarray(infos))
    r, v, c, m = j_vote_candidates(jnet, jpost, n_stages, axis=1)
    jdet = jax.jit(jax.vmap(lambda *a: j_postprocess(*a, jpost, SMALL["canvas"])))(
        r, v, c, m)
    jdet = jax.tree_util.tree_map(np.asarray, jdet)
    jnet = jax.tree_util.tree_map(np.asarray, jnet)

    net = model.apply_batch(torch.from_numpy(imgs), torch.from_numpy(infos))
    post = PostCfg(**POST)
    det = postprocess_detections(*vote_candidates(net, post, n_stages, axis=1), post,
                                 SMALL["canvas"])
    served = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    return jnet, jdet, net, det, served


def test_cascade_outputs_match(both):
    jnet, _, net, _, _ = both
    assert set(net) == set(jnet)
    np.testing.assert_array_equal(net["roi_valid"].numpy(), jnet["roi_valid"])
    assert jnet["roi_valid"].any()
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


def test_bfloat16_conv5_cascade_within_looser_bounds():
    jm, params, model = _models(True, 5, jnp.bfloat16, torch.bfloat16)
    imgs, infos = _inputs()
    jfeat = jm.apply(params, jnp.asarray(imgs), method=JMNC.features)
    jcls, jbox = jm.apply(params, jfeat, method=JMNC.rpn)
    jnet = jm.apply(params, jnp.asarray(imgs), jnp.asarray(infos), method=JMNC.apply_batch)
    with torch.inference_mode():
        feat = model.features(torch.from_numpy(imgs))
        cls, box = model.rpn(feat)
        mask_logits, cls_prob, _ = model._heads(feat, torch.tensor(
            np.asarray(jnet["stage3_rois"])))
    for name, got, want, rel in (("features", feat, jfeat, 0.02), ("rpn cls", cls, jcls, 0.02),
                                 ("rpn bbox", box, jbox, 0.02),
                                 ("mask logits", mask_logits, jnet["stage3_mask_logits"], 0.02)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(cls_prob.numpy(), np.asarray(jnet["stage3_cls_prob"]), rtol=0,
                               atol=0.01)
    assert np.asarray(jnet["roi_valid"]).all()
