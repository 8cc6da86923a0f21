"""Port geometry (anchors, box math, stage bridge, MNCArch anchors) against
the JAX package and the golden fixtures.

Inputs are made with numpy from a seed and fed to both packages.  Anchors
are numpy in both packages and must agree exactly; box math runs in f32 with
the same operation order and must agree to ≤1e-5 (exp/division may round
differently between XLA and PyTorch kernels).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNCArch as JArch, stage_bridge as j_stage_bridge
from mnc_tpu.ops import anchors as j_anchors, bbox as j_bbox
from mnc_tpu_torch.models.mnc import MNCArch, stage_bridge
from mnc_tpu_torch.ops import anchors, bbox
from tests.conftest import random_boxes
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def load(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("kw", [{}, {"scales": (4, 8, 16)}, {"base_size": 8}])
def test_generate_anchors_golden_and_jax(kw):
    g = load("anchors")
    key = {"scales": "small_base", "base_size": "base8_base"}.get(next(iter(kw), ""),
                                                                   "default_base")
    got = anchors.generate_anchors(**kw)
    np.testing.assert_array_equal(got, g[key])
    np.testing.assert_array_equal(got, j_anchors.generate_anchors(**kw))


def test_shifted_anchors_golden_and_jax():
    g = load("anchors")
    np.testing.assert_array_equal(anchors.shifted_anchors(4, 5, 16), g["grid"])
    np.testing.assert_array_equal(anchors.shifted_anchors(40, 64, 16),
                                  j_anchors.shifted_anchors(40, 64, 16))


@pytest.mark.parametrize("canvas,scales", [((640, 1024), (8, 16, 32)),
                                           ((96, 128), (2, 4, 8))])
def test_arch_anchors_and_trainable_mask_match_jax(canvas, scales):
    a = MNCArch(canvas=canvas, anchor_scales=scales)
    ja = JArch(canvas=canvas, anchor_scales=scales)
    np.testing.assert_array_equal(a.all_anchors(), ja.all_anchors())
    np.testing.assert_array_equal(a.trainable_anchor_mask(), ja.trainable_anchor_mask())
    assert (a.pre_nms_top_n, a.post_nms_top_n) == (ja.pre_nms_top_n, ja.post_nms_top_n)


def test_bbox_transform_inv_golden_and_jax():
    g = load("bbox")
    got = bbox.bbox_transform_inv(t(g["ex"]), t(g["deltas"])).numpy()
    np.testing.assert_allclose(got, g["decoded"], rtol=1e-4, atol=1e-3)
    rs = np.random.RandomState(0)
    boxes = random_boxes(rs, 200, h=600.0, w=1000.0)
    deltas = rs.randn(200, 4).astype(np.float32) * 2.0  # some hit the ±8 clamp
    deltas[:5, 2:] = 20.0
    want = np.asarray(j_bbox.bbox_transform_inv(jnp.asarray(boxes), jnp.asarray(deltas)))
    got = bbox.bbox_transform_inv(t(boxes), t(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_clip_boxes_golden_and_jax():
    g = load("bbox")
    h, w = g["im_hw"]
    got = bbox.clip_boxes(t(g["raw"]), (float(h), float(w))).numpy()
    np.testing.assert_allclose(got, g["clipped"], rtol=1e-5, atol=1e-4)
    want = np.asarray(j_bbox.clip_boxes(jnp.asarray(g["raw"], jnp.float32),
                                        (jnp.float32(h), jnp.float32(w))))
    np.testing.assert_array_equal(
        bbox.clip_boxes(t(g["raw"]), (t(h), t(w))).numpy(), want)


def test_bbox_overlaps_golden_and_jax():
    g = load("bbox")
    got = bbox.bbox_overlaps(t(g["ex"][:20]), t(g["query"])).numpy()
    np.testing.assert_allclose(got, g["overlaps"], rtol=1e-5, atol=1e-6)
    rs = np.random.RandomState(1)
    a = random_boxes(rs, 50)
    b = random_boxes(rs, 40)
    b[:3] = [[5, 5, 4, 4], [0, 0, 0, 0], [10, 10, 9, 20]]  # degenerate: union < 1
    want = np.asarray(j_bbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(bbox.bbox_overlaps(t(a), t(b)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_stage_bridge_golden_and_jax():
    g = load("stage_bridge")
    h, w = g["im_hw"]
    im_info = t([h, w, 1.0])
    args = (t(g["rois"]), t(g["cls_prob"]), t(g["bbox_pred"]), im_info)
    arch = MNCArch(num_classes=6)
    got = stage_bridge(*args, arch).numpy()
    np.testing.assert_allclose(got, g["refined"], rtol=1e-4, atol=1e-4)
    raw = stage_bridge(*args, arch, bbox_pred_normalized=False).numpy()
    np.testing.assert_allclose(raw, g["refined_raw"], rtol=1e-4, atol=1e-4)
    arch2 = MNCArch(num_classes=6, bbox_means=tuple(g["means2"]))
    np.testing.assert_allclose(stage_bridge(*args, arch2).numpy(), g["refined_means2"],
                               rtol=1e-4, atol=1e-4)
    jargs = tuple(jnp.asarray(x.numpy()) for x in args)
    want = np.asarray(j_stage_bridge(*jargs, JArch(num_classes=6)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_stage_bridge_batched_and_argmax_ties():
    """The bridge takes the FIRST maximum foreground class, as jnp.argmax;
    a batch dim gives the per-image results."""
    rs = np.random.RandomState(2)
    n, c = 10, 5
    rois = random_boxes(rs, n, h=300.0, w=400.0)
    prob = np.full((n, c), 0.2, np.float32)  # every foreground class ties
    pred = rs.randn(n, 4 * c).astype(np.float32) * 0.1
    info = np.array([300.0, 400.0, 1.0], np.float32)
    arch, jarch = MNCArch(num_classes=c), JArch(num_classes=c)
    want = np.asarray(j_stage_bridge(jnp.asarray(rois), jnp.asarray(prob),
                                     jnp.asarray(pred), jnp.asarray(info), jarch))
    got = stage_bridge(t(rois), t(prob), t(pred), t(info), arch).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    batched = stage_bridge(t(np.stack([rois, rois])), t(np.stack([prob, prob])),
                           t(np.stack([pred, pred])), t(np.stack([info, info])), arch)
    np.testing.assert_array_equal(batched[1].numpy(), got)
