"""The port's target assignment (``mnc_tpu_torch/train/targets.py``) against
the JAX package with JAX's own uniform draws fed in, and against the golden
fixtures.  Selections (labels, sampled indices through the RoIs, mask
targets) must be identical; float targets agree to rtol 1e-5 / atol 1e-5
(f32 on both sides).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.anchors import shifted_anchors
from mnc_tpu.train import targets as JT
from mnc_tpu_torch.train import targets as T
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def load(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def t(x):
    return torch.tensor(np.asarray(x))


def jax_draws(key, n):
    """The two uniform tensors a JAX target function draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (t(jax.random.uniform(k1, (n,))), t(jax.random.uniform(k2, (n,))))


def _gt(rs, g, n_valid, hw=(128, 160)):
    xy = rs.uniform(0, [hw[1] - 50, hw[0] - 50], size=(g, 2))
    wh = rs.uniform(16, 48, size=(g, 2))
    boxes = np.floor(np.concatenate([xy, xy + wh], 1)).astype(np.float32)
    valid = np.arange(g) < n_valid
    boxes[~valid] = 0
    classes = np.where(valid, rs.randint(1, 4, size=g), 0).astype(np.int32)
    masks = (rs.uniform(size=(g, 16, 16)) > 0.3).astype(np.float32) * valid[:, None, None]
    return boxes, classes, valid, masks


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(positive_weight=0.3),
                                dict(clobber_positives=True, batch_size=32),
                                dict(pos_overlap=0.5, neg_overlap=0.4, batch_size=16,
                                     inside_weights=(1.0, 2.0, 0.5, 1.0))])
@pytest.mark.parametrize("seed,n_valid", [(0, 3), (1, 1), (2, 0)])
def test_anchor_targets_match_jax(kw, seed, n_valid):
    rs = np.random.RandomState(seed)
    anchors = shifted_anchors(8, 10, 16, scales=(2, 4, 8)).astype(np.float32)
    boxes, _, valid, _ = _gt(rs, 4, n_valid)
    key = jax.random.PRNGKey(seed + 10)
    kw = dict(dict(batch_size=64), **kw)
    want = JT.anchor_targets(jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(valid),
                             (120.0, 150.0), key, **kw)
    got = T.anchor_targets(t(anchors), t(boxes), t(valid),
                           (torch.tensor(120.0), torch.tensor(150.0)),
                           jax_draws(key, len(anchors)), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32
    for a, b in zip(got[1:], want[1:]):
        _close(a, b)
    if n_valid == 0:  # empty ground truth: negatives only
        assert not (got.labels == 1).any() and (got.labels == 0).any()


def test_random_keep_ties_and_quota():
    """Exactly tied draws rank by index, as ``lax.top_k`` ranks them."""
    rs = np.random.RandomState(3)
    for trial in range(6):
        n = [5, 64, 257, 1024, 40, 40][trial]
        r = np.round(rs.uniform(size=n) * 8) / 8  # many exact ties
        eligible = rs.uniform(size=n) < [1.0, 0.5, 0.05, 0.5, 0.0, 1.0][trial]
        max_q = [3, 16, 128, 64, 8, 64][trial]
        quota = rs.randint(0, max_q + 1)
        rj = jnp.where(jnp.asarray(eligible), jnp.asarray(r, jnp.float32), 2.0)
        k = min(max_q, n)
        _, idx = jax.lax.top_k(-rj, k)
        want = np.zeros(n, bool)
        want[np.asarray(idx)] = np.arange(k) < quota
        want &= eligible
        got = T._random_keep(t(r.astype(np.float32)), t(eligible), torch.tensor(quota), max_q)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == min(quota, int(eligible.sum()))


def test_first_argmax_breaks_ties_low():
    x = torch.tensor([[0.0, 0.0, 0.0], [1.0, 3.0, 3.0], [2.0, 1.0, 2.0]])
    np.testing.assert_array_equal(T.first_argmax(x).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=1)))


def _rois(rs, n, gt_boxes, n_valid):
    """Proposals: jittered copies of the gt boxes (fg), far boxes (bg)."""
    near = gt_boxes[rs.randint(0, max(n_valid, 1), size=n // 2)] + rs.uniform(-6, 6, (n // 2, 4))
    xy = rs.uniform(0, 110, size=(n - n // 2, 2))
    far = np.concatenate([xy, xy + rs.uniform(8, 40, (n - n // 2, 2))], 1)
    return np.concatenate([near, far]).astype(np.float32)


@pytest.mark.parametrize("n_rois,roi_batch,n_valid,seed", [
    (48, 32, 3, 0),   # a pool larger than the batch: both quotas bind
    (20, 32, 2, 1),   # pool (20 + 4) smaller than the batch: padded pool, -1 labels
    (48, 32, 0, 2),   # empty ground truth: background only
    (64, 16, 4, 3)])
def test_proposal_targets_match_jax(n_rois, roi_batch, n_valid, seed):
    rs = np.random.RandomState(seed)
    boxes, classes, valid, gmasks = _gt(rs, 4, n_valid)
    rois = _rois(rs, n_rois, boxes, n_valid)
    roi_valid = rs.uniform(size=n_rois) > 0.1
    key = jax.random.PRNGKey(seed + 20)
    kw = dict(roi_batch=roi_batch, mask_size=9, fg_fraction=0.25)
    want = JT.proposal_targets(jnp.asarray(rois), jnp.asarray(roi_valid), jnp.asarray(boxes),
                               jnp.asarray(classes), jnp.asarray(valid), jnp.asarray(gmasks),
                               key, **kw)
    pool = T.proposal_pool_size(n_rois, 4, roi_batch)
    got = T.proposal_targets(t(rois), t(roi_valid), t(boxes), t(classes), t(valid),
                             t(gmasks), jax_draws(key, pool), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))  # same indices
    np.testing.assert_array_equal(got.mask_targets.numpy(), np.asarray(want.mask_targets))
    np.testing.assert_array_equal(got.bbox_weight.numpy(), np.asarray(want.bbox_weight))
    np.testing.assert_array_equal(got.mask_weight.numpy(), np.asarray(want.mask_weight))
    _close(got.bbox_targets, want.bbox_targets)
    if n_rois + 4 < roi_batch:
        assert (got.labels == -1).sum() >= roi_batch - (n_rois + 4)
    if n_valid == 0:
        assert not (got.labels > 0).any() and float(got.mask_weight.sum()) == 0.0

    # the second pass: re-targets of jittered RoIs keep the -1 padding
    rois2 = np.asarray(want.rois) + rs.uniform(-4, 4, (roi_batch, 4)).astype(np.float32)
    want2 = JT.reassign_targets(jnp.asarray(rois2), want.labels, jnp.asarray(boxes),
                                jnp.asarray(classes), jnp.asarray(valid),
                                jnp.asarray(gmasks), mask_size=9)
    got2 = T.reassign_targets(t(rois2), got.labels, t(boxes), t(classes), t(valid),
                              t(gmasks), mask_size=9)
    np.testing.assert_array_equal(got2.labels.numpy(), np.asarray(want2.labels))
    np.testing.assert_array_equal(got2.mask_targets.numpy(), np.asarray(want2.mask_targets))
    np.testing.assert_array_equal((got2.labels == -1).numpy(), (got.labels == -1).numpy())
    _close(got2.bbox_targets, want2.bbox_targets)


def test_proposal_targets_gradient_reaches_rois_as_in_jax():
    """Nothing is detached: the box targets are differentiable in the
    sampled RoIs, in both packages."""
    rs = np.random.RandomState(5)
    boxes, classes, valid, gmasks = _gt(rs, 4, 3)
    rois = _rois(rs, 40, boxes, 3)
    key = jax.random.PRNGKey(9)
    args = (jnp.ones(40, bool), jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
            jnp.asarray(gmasks), key)
    want = jax.grad(lambda r: (JT.proposal_targets(r, *args, roi_batch=32, mask_size=9)
                               .bbox_targets ** 2).sum())(jnp.asarray(rois))
    tr = torch.tensor(rois, requires_grad=True)
    got = T.proposal_targets(tr, torch.ones(40, dtype=torch.bool), t(boxes), t(classes),
                             t(valid), t(gmasks), jax_draws(key, 44), roi_batch=32, mask_size=9)
    (got.bbox_targets ** 2).sum().backward()
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _golden_anchor(g, gt, **kw):
    n = len(g["anchors"])
    return T.anchor_targets(t(g["anchors"].astype(np.float32)), t(gt.astype(np.float32)),
                            torch.ones(len(gt), dtype=torch.bool),
                            tuple(float(v) for v in g["im_hw"]),
                            jax_draws(jax.random.PRNGKey(0), n), **kw)


def test_golden_anchor_targets():
    g = load("anchor_targets")
    out = _golden_anchor(g, g["gt"])
    np.testing.assert_array_equal(out.labels.numpy(), g["labels"])
    pos = g["labels"] == 1
    np.testing.assert_allclose(out.bbox_targets.numpy()[pos], g["targets"][pos], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.bbox_inside_w.numpy(), g["inside_w"], atol=1e-6)
    np.testing.assert_allclose(out.bbox_outside_w.numpy(), g["outside_w"], rtol=1e-5,
                               atol=1e-7)
    pw = _golden_anchor(g, g["gt"], positive_weight=0.5)
    np.testing.assert_array_equal(pw.labels.numpy(), g["labels_pw"])
    np.testing.assert_allclose(pw.bbox_outside_w.numpy(), g["outside_w_pw"], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("clobber", [False, True])
def test_golden_anchor_targets_clobber(clobber):
    g = load("anchor_targets")
    out = _golden_anchor(g, g["gt_clob"], clobber_positives=clobber)
    np.testing.assert_array_equal(out.labels.numpy(),
                                  g["labels_clob"] if clobber else g["labels_noclob"])


def test_golden_proposal_targets():
    g = load("proposal_targets")
    rb = int(g["roi_batch"][0])
    pool = T.proposal_pool_size(len(g["rois"]), len(g["gt"]), rb)
    out = T.proposal_targets(
        t(g["rois"].astype(np.float32)), torch.ones(len(g["rois"]), dtype=torch.bool),
        t(g["gt"].astype(np.float32)), t(g["gt_classes"].astype(np.int32)),
        torch.ones(len(g["gt"]), dtype=torch.bool), t(g["gt_masks"].astype(np.float32)),
        jax_draws(jax.random.PRNGKey(7), pool), roi_batch=rb,
        mask_size=int(g["mask_size"][0]))
    np.testing.assert_array_equal(out.labels.numpy(), g["labels"])
    n_real = int((g["labels"] >= 0).sum())
    np.testing.assert_allclose(out.rois.numpy()[:n_real], g["s_rois"][:n_real], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(out.bbox_targets.numpy(), g["bbox_targets"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(out.bbox_weight.numpy(), g["bbox_weight"])
    np.testing.assert_array_equal(out.mask_targets.numpy(), g["mask_targets"])
    np.testing.assert_array_equal(out.mask_weight.numpy(), g["mask_weight"])
