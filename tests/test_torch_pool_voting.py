"""The port's ``roi_pool`` (``ops/roi_warp.py``), whole-class ``mask_voting``
/ ``box_voting`` and the ``gather`` voting route (``ops/mask_voting.py``,
``PostCfg.vote_impl``) against the JAX package's functions and the golden
fixtures, on seeded inputs.

Tolerances: ``roi_pool`` bit for bit (a max selects a value), its gradient
with ties bit for bit per RoI (each tie's share is ``g / count``, in the
same order in both) and within 1e-6 over all RoIs (a cell several RoIs
pool sums their shares in another order); against the golden fixture
within 1e-5, as the JAX package's own test.  Whole-class voting within
5e-6 absolute of JAX and of the golden fixture (the same f32 products
summed in another order: JAX itself lies 1.4e-6 from a float64 evaluation
of these cases and 2.3e-6 from the fixture, whose own test allows 1e-5);
box voting within 1e-4 px.  The gather route within 1e-6 of JAX's gather
and of the port's einsum route (both the same math to f32 rounding).  A
small model's post-processing under ``TEST.VOTE_IMPL gather``: selections
identical, boxes within 1e-4 px, scores within 1e-6, soft masks within
1e-5.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.roi_warp import roi_pool as j_roi_pool
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.pipeline.inference import postprocess_detections as j_postprocess
from mnc_tpu.pipeline.inference import vote_candidates as j_vote_candidates
from mnc_tpu_torch import ops
from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.ops import mask_voting as mv
from mnc_tpu_torch.ops import roi_warp as roi_warp_mod
from mnc_tpu_torch.pipeline.inference import PostCfg, postprocess_detections, vote_candidates
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

jmv = importlib.import_module("mnc_tpu.ops.mask_voting")  # the package exports a function
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def golden(name):
    return dict(np.load(os.path.join(GOLDEN, f"{name}.npz")))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- roi_pool ----


@pytest.mark.parametrize("hw", [(7, 7), (3, 4)])
def test_roi_pool_golden(hw):
    """Corners rounded half away from zero (the fixture has 8/16 = 0.5),
    exact integer bin edges."""
    g = golden("roi_pool")
    feat, rois = g["feat"].astype(np.float32), g["rois"].astype(np.float32)
    scale = float(g["scale"][0])
    got = ops.roi_pool(t(feat), t(rois), hw, scale).numpy()
    np.testing.assert_allclose(got, g[f"out_{hw[0]}x{hw[1]}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, np.asarray(j_roi_pool(feat, rois, hw, scale)))


def _pool_case(seed, h=11, w=13, c=3, n=9, levels=None):
    rs = np.random.RandomState(seed)
    feat = (rs.randint(0, levels, (h, w, c)) if levels else rs.randn(h, w, c)).astype(np.float32)
    x1, y1 = rs.uniform(-20, 150, n), rs.uniform(-20, 120, n)
    rois = np.stack([x1, y1, x1 + rs.uniform(0, 120, n), y1 + rs.uniform(0, 100, n)], 1)
    rois[0] = [8.0, 24.0, 40.0, 56.0]  # corners on .5 at 1/16: round away from zero
    rois[1] = [-8.0, -24.0, 8.0, 8.0]  # negative .5 corners
    rois[2] = [400.0, 300.0, 420.0, 330.0]  # outside the map: every bin empty -> 0
    rois[3] = [16.0, 16.0, 16.0, 16.0]  # one cell: most bins of a 3x4 grid repeat it
    return feat, rois.astype(np.float32)


@pytest.mark.parametrize("hw", [(3, 4), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pool_matches_jax(hw, dtype, monkeypatch):
    feat, rois = _pool_case(1)
    want = np.asarray(j_roi_pool(jnp.asarray(feat, dtype), rois, hw, 1 / 16).astype(jnp.float32))
    got = ops.roi_pool(t(feat).to(getattr(torch, dtype)), t(rois), hw, 1 / 16)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[2].any()  # empty bins are 0
    # batched form, and chunks of one RoI, give the same values
    monkeypatch.setattr(roi_warp_mod, "POOL_CHUNK_ELEMS", 1)
    batched = ops.roi_pool(t(np.stack([feat, feat[::-1].copy()])),
                           t(np.stack([rois, rois])), hw, 1 / 16)
    np.testing.assert_array_equal(batched[0].float().numpy(),
                                  got.float().numpy() if dtype == "float32"
                                  else ops.roi_pool(t(feat), t(rois), hw, 1 / 16).numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_roi_pool_gradient_ties_match_jax(seed):
    """Features on 3 levels, so most bins tie, some unevenly across rows and
    columns: the two-stage even split of JAX's ``max``, bit for bit for each
    RoI alone; all RoIs at once within 1e-6 relative (a cell that several
    RoIs pool sums their shares in another order than XLA); no gradient to
    the boxes."""
    feat, rois = _pool_case(seed, levels=3)
    rs = np.random.RandomState(seed + 10)
    cot = rs.randn(len(rois), 3, 4, 3).astype(np.float32)

    def grads(sel):
        want = np.asarray(jax.grad(lambda f: jnp.sum(
            j_roi_pool(f, rois[sel], (3, 4), 1 / 16) * cot[sel]))(jnp.asarray(feat)))
        f = t(feat).requires_grad_(True)
        r = t(rois[sel]).requires_grad_(True)
        (ops.roi_pool(f, r, (3, 4), 1 / 16) * t(cot[sel])).sum().backward()
        assert r.grad is None or not r.grad.any()
        return f.grad.numpy(), want

    shares = set()
    for i in range(len(rois)):
        got, want = grads(slice(i, i + 1))
        np.testing.assert_array_equal(got, want)
        shares.update(np.round(np.abs(want[want != 0] / np.abs(cot[i]).max()), 6).tolist())
    got, want = grads(slice(None))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # ties were split: shares that are no whole cotangent entry
    assert len(shares) > 2 * cot[0].size


# ---- whole-class voting ----


def _vote_case(seed, n=5, k=37, m=9):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 60, (k, 2))
    cand = np.concatenate([xy, xy + rs.uniform(6, 40, (k, 2))], 1).astype(np.float32)
    kept = (cand[:n] + rs.uniform(-3, 3, (n, 4))).astype(np.float32)
    kept[-1] = [300, 300, 320, 330]  # no neighbor
    scores = rs.uniform(0.05, 1.0, k).astype(np.float32)
    masks = rs.uniform(size=(k, m, m)).astype(np.float32)
    valid = rs.uniform(size=k) > 0.15
    return kept, cand, scores, masks, valid


@pytest.mark.parametrize("chunk", [8, 32])
def test_mask_voting_chunked_matches_jax(chunk):
    """K = 37 is no multiple of the chunk: the padding votes nothing."""
    kept, cand, scores, masks, valid = _vote_case(chunk)
    want = np.asarray(jmv.mask_voting(kept, cand, scores, masks, valid, 0.5, chunk=chunk))
    got = mv.mask_voting(t(kept), t(cand), t(scores), t(masks), t(valid), 0.5, chunk=chunk)
    assert got.shape == want.shape == (5, 9, 9) and np.abs(want[:-1]).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    assert not got[-1].any()


def test_box_voting_matches_jax():
    kept, cand, scores, _, valid = _vote_case(5)
    for v in (None, valid):
        want = np.asarray(jmv.box_voting(kept, cand, scores, v, 0.5))
        got = mv.box_voting(t(kept), t(cand), t(scores), None if v is None else t(v), 0.5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[-1].numpy(), kept[-1])  # no neighbor: unchanged


def test_voting_golden():
    g = golden("mask_voting")
    f32 = {k: t(v.astype(np.float32)) for k, v in g.items()}
    k = len(g["cand"])
    merged = mv.mask_voting(f32["kept"], f32["cand"], f32["scores"], f32["masks"],
                             torch.ones(k, dtype=torch.bool), 0.5, chunk=4)
    np.testing.assert_allclose(merged.numpy(), g["merged"], rtol=0, atol=5e-6)
    voted = mv.box_voting(f32["kept"], f32["cand"], f32["scores"], iou_thresh=0.5)
    np.testing.assert_allclose(voted.numpy(), g["voted_boxes"], rtol=1e-5, atol=1e-3)


# ---- the gather route ----


def test_resample_gather_matches_jax():
    rs = np.random.RandomState(2)
    masks = rs.uniform(size=(4, 6, 11, 11)).astype(np.float32)
    cy = rs.uniform(-3, 14, (4, 6, 9)).astype(np.float32)
    cx = rs.uniform(-3, 14, (4, 6, 9)).astype(np.float32)
    cy[0, 0, :3] = [-1.0, 0.0, 10.0]  # integer taps, at and past the edges
    want = np.asarray(jmv._resample_gather(masks, cy, cx))
    got = mv._resample_gather(t(masks), t(cy), t(cx))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    (lo, wlo), (hi, whi) = mv._lerp_taps(t(cy), 11)
    (jlo, jwlo), (jhi, jwhi) = jmv._lerp_taps(cy, 11)
    for a, b in ((lo, jlo), (hi, jhi), (wlo, jwlo), (whi, jwhi)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mask_voting_per_det_gather_matches_jax_and_einsum():
    kept, cand, scores, masks, _ = _vote_case(7, n=6, k=12)
    n = len(kept)
    cb = np.broadcast_to(cand, (n, *cand.shape)).copy()
    cs = np.broadcast_to(scores, (n, len(scores))).copy()
    cm = np.broadcast_to(masks, (n, *masks.shape)).copy()
    want = np.asarray(jmv.mask_voting_per_det(kept, cb, cs, cm, 0.5, impl="gather"))
    got = mv.mask_voting_per_det(t(kept), t(cb), t(cs), t(cm), 0.5, impl="gather")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    einsum = mv.mask_voting_per_det(t(kept), t(cb), t(cs), t(cm), 0.5)
    np.testing.assert_allclose(got.numpy(), einsum.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="vote impl"):
        mv.mask_voting_per_det(t(kept), t(cb), t(cs), t(cm), 0.5, impl="pallas")


def _net_out(seed, b=2, n=32, c=4, m=9):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 80, size=(2, b, n, 2)).astype(np.float32)
    rois = np.concatenate([xy[0], xy[0] + rs.uniform(8, 48, (b, n, 2))], -1).astype(np.float32)
    prob = rs.dirichlet(np.ones(c), size=(2, b, n)).astype(np.float32)
    logits = rs.randn(2, b, n, m, m).astype(np.float32)
    return {"rois": rois, "roi_valid": rs.uniform(size=(b, n)) > 0.2, "cls_prob": prob[0],
            "mask_logits": logits[0], "stage3_rois": rois[:, ::-1].copy(),
            "stage3_cls_prob": prob[1], "stage3_mask_logits": logits[1]}


@pytest.mark.parametrize("vote_boxes", [False, True])
def test_postprocess_vote_impl_gather_matches_jax(vote_boxes):
    """``TEST.VOTE_IMPL gather`` reaches the post-processing through
    ``PostCfg.from_cfg``, as in the JAX package."""
    canvas = (96, 128)
    post_kw = dict(dets_per_class=4, max_per_image=8, vote_boxes=vote_boxes)
    net = _net_out(11 + vote_boxes)
    jpost = JPostCfg(paste_impl="pallas", paste_dtype="f32", vote_impl="gather", **post_kw)
    r, v, c, m = j_vote_candidates({k: jnp.asarray(x) for k, x in net.items()}, jpost, 5, axis=1)
    want = jax.jit(jax.vmap(lambda *a: j_postprocess(*a, jpost, canvas)))(r, v, c, m)
    old = cfg.TEST.VOTE_IMPL
    cfg.TEST.VOTE_IMPL = "gather"
    try:
        post = PostCfg.from_cfg(**post_kw)
    finally:
        cfg.TEST.VOTE_IMPL = old
    assert post.vote_impl == "gather"
    got = postprocess_detections(*vote_candidates(
        {k: torch.from_numpy(x) for k, x in net.items()}, post, 5, axis=1), post, canvas)
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key, tol in (("boxes", 1e-4), ("scores", 1e-6), ("masks", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=tol)
    assert (got["canvas_masks"].numpy() != np.asarray(want["canvas_masks"])).mean() < 1e-4
