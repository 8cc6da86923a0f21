"""The port's training ops (``bbox_transform``, ``intersect_mask``, the three
losses) against the JAX package on numpy-seeded inputs, values and gradients,
and against the independent golden fixtures.

Tolerances: f32 on both sides, so values agree to rtol 1e-5 (the losses sum
hundreds of terms in different orders) and gradients to rtol 1e-5 / atol
1e-6; binarized mask targets are identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops import bbox as jbbox
from mnc_tpu.ops import losses as jlosses
from mnc_tpu.ops import masks as jmasks
from mnc_tpu_torch.ops import bbox, losses, masks
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def load(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _boxes(rs, n, lo=4.0, hi=90.0):
    xy = rs.uniform(0, 100, size=(n, 2))
    wh = rs.uniform(lo, hi, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_bbox_transform_matches_jax_values_and_grads():
    rs = np.random.RandomState(0)
    ex, gt = _boxes(rs, 64), _boxes(rs, 64)
    ex[:4] = 0.0  # padded boxes: width exactly 1, the clamp's tie
    cot = rs.randn(64, 4).astype(np.float32)
    want, vjp = jax.vjp(jbbox.bbox_transform, jnp.asarray(ex), jnp.asarray(gt))
    wex, wgt = vjp(jnp.asarray(cot))
    tex, tgt = t(ex, True), t(gt, True)
    got = bbox.bbox_transform(tex, tgt)
    got.backward(t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tex.grad.numpy(), np.asarray(wex), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgt.grad.numpy(), np.asarray(wgt), rtol=1e-5, atol=1e-6)


def test_bbox_transform_golden_and_inverse():
    g = load("bbox")
    got = bbox.bbox_transform(t(g["ex"]), t(g["gt"]))
    np.testing.assert_allclose(got.numpy(), g["targets"], rtol=1e-5, atol=1e-5)
    back = bbox.bbox_transform_inv(t(g["ex"]), got)
    np.testing.assert_allclose(back.numpy(), g["gt"], rtol=1e-4, atol=1e-3)


def test_bbox_transform_inv_grads_match_jax():
    rs = np.random.RandomState(1)
    ex = _boxes(rs, 32)
    d = (rs.randn(32, 4) * 0.3).astype(np.float32)
    cot = rs.randn(32, 4).astype(np.float32)
    _, vjp = jax.vjp(jbbox.bbox_transform_inv, jnp.asarray(ex), jnp.asarray(d))
    wex, wd = vjp(jnp.asarray(cot))
    tex, td = t(ex, True), t(d, True)
    bbox.bbox_transform_inv(tex, td).backward(t(cot))
    np.testing.assert_allclose(tex.grad.numpy(), np.asarray(wex), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def test_clip_boxes_tie_gradient_matches_jax():
    """At a coordinate already on the border both packages pass half of the
    gradient (maximum/minimum ties), where a clamp would pass all of it."""
    b = np.array([[0.0, 5.0, 159.0, 127.0], [-3.0, 0.0, 200.0, 50.0]], np.float32)
    want = jax.grad(lambda x: jbbox.clip_boxes(x, (128.0, 160.0)).sum())(jnp.asarray(b))
    tb = t(b, True)
    bbox.clip_boxes(tb, (128.0, 160.0)).sum().backward()
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("binarize", [True, False])
def test_intersect_mask_matches_jax(binarize):
    rs = np.random.RandomState(2)
    rois, gtb = _boxes(rs, 24), _boxes(rs, 24)
    gtm = (rs.uniform(size=(24, 16, 16)) > 0.4).astype(np.float32)
    want = np.asarray(jmasks.intersect_mask(jnp.asarray(rois), jnp.asarray(gtb),
                                            jnp.asarray(gtm), 9, binarize=binarize))
    got = masks.intersect_mask(t(rois), t(gtb), t(gtm), 9, binarize=binarize).numpy()
    if binarize:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a leading batch axis gives the same numbers
    got_b = masks.intersect_mask(t(rois).reshape(2, 12, 4), t(gtb).reshape(2, 12, 4),
                                 t(gtm).reshape(2, 12, 16, 16), 9, binarize=binarize)
    np.testing.assert_array_equal(got_b.reshape(24, 9, 9).numpy(), got)


def test_intersect_mask_golden():
    g = load("intersect_mask")
    args = (t(g["rois"].astype(np.float32)), t(g["gt_boxes"].astype(np.float32)),
            t(g["gt_masks"].astype(np.float32)), 21)
    np.testing.assert_allclose(masks.intersect_mask(*args, binarize=False).numpy(),
                               g["soft"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(masks.intersect_mask(*args).numpy(), g["binary"])


def _grad_pair(jfn, tfn, arrays, diff=(0,)):
    """Value and gradients (w.r.t. the ``diff`` args) of a scalar loss, both sides."""
    jargs = [jnp.asarray(a) for a in arrays]
    want, wgrads = jax.value_and_grad(jfn, argnums=diff)(*jargs)
    targs = [t(a, i in diff) for i, a in enumerate(arrays)]
    got = tfn(*targs)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for i, wg in zip(diff, wgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_matches_jax(sigma):
    rs = np.random.RandomState(3)
    pred, tgt = rs.randn(50, 4).astype(np.float32), rs.randn(50, 4).astype(np.float32)
    iw = (rs.uniform(size=(50, 4)) > 0.3).astype(np.float32)
    ow = rs.uniform(size=(50, 4)).astype(np.float32) / 50
    _grad_pair(lambda p, q, a, b: jlosses.smooth_l1_loss(p, q, a, b, sigma=sigma),
               lambda p, q, a, b: losses.smooth_l1_loss(p, q, a, b, sigma=sigma),
               [pred, tgt, iw, ow], diff=(0, 1))
    _grad_pair(jlosses.smooth_l1_loss, losses.smooth_l1_loss, [pred, tgt])


@pytest.mark.parametrize("normalize", [True, False])
def test_softmax_ce_matches_jax(normalize):
    rs = np.random.RandomState(4)
    logits = (rs.randn(40, 5) * 2).astype(np.float32)
    labels = rs.randint(-1, 5, size=40).astype(np.int32)
    _grad_pair(lambda x, y: jlosses.softmax_cross_entropy(x, y, -1, normalize),
               lambda x, y: losses.softmax_cross_entropy(x, y, -1, normalize),
               [logits, labels])
    all_ignored = np.full(40, -1, np.int32)  # count clamps to 1, loss is 0
    assert float(losses.softmax_cross_entropy(t(logits), t(all_ignored))) == 0.0


@pytest.mark.parametrize("mode", ["weights", "weights_sum", "plain"])
def test_sigmoid_ce_matches_jax(mode):
    rs = np.random.RandomState(5)
    x = (rs.randn(6, 9, 9) * 3).astype(np.float32)
    tg = (rs.uniform(size=(6, 9, 9)) > 0.5).astype(np.float32)
    w = (rs.uniform(size=(6, 1, 1)) > 0.4).astype(np.float32)
    if mode == "plain":
        _grad_pair(jlosses.sigmoid_cross_entropy, losses.sigmoid_cross_entropy, [x, tg])
    else:
        norm = mode == "weights"
        _grad_pair(lambda a, b, c: jlosses.sigmoid_cross_entropy(a, b, c, norm),
                   lambda a, b, c: losses.sigmoid_cross_entropy(a, b, c, norm), [x, tg, w])


def test_losses_golden():
    g = load("losses")
    a = tuple(t(g[k].astype(np.float32)) for k in ("pred", "tgt", "iw", "ow"))
    np.testing.assert_allclose(float(losses.smooth_l1_loss(*a, sigma=1.0)), g["sl1_s1"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(float(losses.smooth_l1_loss(*a, sigma=3.0)), g["sl1_s3"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(float(losses.smooth_l1_loss(a[0], a[1])), g["sl1_plain"][0],
                               rtol=1e-5)
    got = losses.softmax_cross_entropy(t(g["logits"].astype(np.float32)),
                                       t(g["labels"].astype(np.int32)))
    np.testing.assert_allclose(float(got), g["sce"][0], rtol=1e-5)
    m = tuple(t(g[k].astype(np.float32)) for k in ("mlogits", "mtgt", "mw"))
    np.testing.assert_allclose(float(losses.sigmoid_cross_entropy(*m)), g["bce"][0], rtol=1e-5)
    np.testing.assert_allclose(float(losses.sigmoid_cross_entropy(m[0], m[1])),
                               g["bce_plain"][0], rtol=1e-5)
