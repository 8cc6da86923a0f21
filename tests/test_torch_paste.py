"""Port canvas paste (the plain twin of kernel C) and mask/box voting against
the JAX package.

The paste hats must match JAX's ``_paste_axis_weights`` to ≤1e-6 (argmin
edge clamp included).  The binarized canvases must equal
``paste_binarize_pallas`` (interpret mode) bit for bit, except pixels whose
f32 product lies within 1e-6 of the threshold (summation order differs).
Voting runs in f32 and must match JAX (``precision="highest"``) to ≤1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.mask_voting import box_voting_per_det as j_box_voting_per_det
from mnc_tpu.ops.mask_voting import mask_voting_per_det as j_mask_voting_per_det
from mnc_tpu.ops.masks import _paste_axis_weights as j_weights
from mnc_tpu.ops.masks import paste_masks as j_paste_masks
from mnc_tpu.ops.pallas.paste_kernel import paste_binarize_pallas
from mnc_tpu_torch.ops import mask_voting as mv
from mnc_tpu_torch.ops.masks import _paste_axis_weights, paste_binarize_plain, paste_masks

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
CANVAS = (96, 128)


def _dets(seed, n, m=21):
    rs = np.random.RandomState(seed)
    h, w = CANVAS
    x1 = rs.uniform(-10, w - 5, n)
    y1 = rs.uniform(-10, h - 5, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(4, 60, n), y1 + rs.uniform(4, 40, n)],
                     1).astype(np.float32)
    boxes[:4] = [[0, 0, 0, 0], [-50, -50, -20, -20], [200, 200, 400, 400],
                 [30, 20, 10, 5]]  # zero-area, outside, beyond, inverted
    masks = 1.0 / (1.0 + np.exp(-2.0 * rs.randn(n, m, m)))
    return masks.astype(np.float32), boxes


@pytest.mark.parametrize("m,out_len", [(21, 96), (9, 128), (28, 40)])
def test_paste_axis_weights_match_jax(m, out_len):
    _, boxes = _dets(m, 24)
    for lo, hi in ((1, 3), (0, 2)):
        want = np.asarray(j_weights(jnp.asarray(boxes[:, lo]), jnp.asarray(boxes[:, hi]),
                                    m, out_len))
        got = _paste_axis_weights(torch.from_numpy(boxes[:, lo]),
                                  torch.from_numpy(boxes[:, hi]), m, out_len)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _assert_canvas_match(got, want, prod, thresh, eps):
    mism = got != want
    assert np.abs(prod[mism] - thresh).max(initial=0.0) < eps
    assert mism.mean() < 1e-4


@pytest.mark.parametrize("seed,n,m", [(0, 16, 21), (1, 12, 28)])
def test_paste_matches_pallas_interpret(seed, n, m):
    masks, boxes = _dets(seed, n, m)
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), CANVAS, 0.4)
    assert got.dtype == torch.bool and got.shape == (n, *CANVAS)
    h, w = CANVAS
    jb = jnp.asarray(boxes)
    wy = j_weights(jb[:, 1], jb[:, 3], m, h)
    wx = j_weights(jb[:, 0], jb[:, 2], m, w)
    want = np.asarray(paste_binarize_pallas(wy, jnp.asarray(masks),
                                            jnp.swapaxes(wx, -1, -2), 0.4))
    prod = np.asarray(j_paste_masks(jnp.asarray(masks), jb, CANVAS, None))
    _assert_canvas_match(got.numpy(), want, prod, 0.4, 1e-6)
    assert not got[1:3].any()  # boxes outside the canvas paste nothing


def test_paste_batched_leading_dims():
    masks, boxes = _dets(2, 8)
    flat = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), CANVAS, 0.4)
    batched = paste_masks(torch.from_numpy(masks).reshape(2, 4, 21, 21),
                          torch.from_numpy(boxes).reshape(2, 4, 4), CANVAS, 0.4)
    np.testing.assert_array_equal(batched.reshape(8, *CANVAS).numpy(), flat.numpy())


# ---- kernel C (csrc/paste.cu), modelled step by step
BAND, WORD, CHUNK_WORDS = 32, 16, 16  # rows per band, pixels per store, words per chunk


def _extent_model(wy, wxt):
    """The extent pass: (N, 4) [c0, c1) of the wxt columns and [r0, r1) of
    the wy rows that are not all zero; (0, 0) where all are."""
    out = np.zeros((wxt.shape[0], 4), np.int64)
    for i in range(len(out)):
        for k, nz in enumerate(((wxt[i] != 0).any(0), (wy[i] != 0).any(1))):
            idx = np.flatnonzero(nz)
            if len(idx):
                out[i, 2 * k:2 * k + 2] = idx[0], idx[-1] + 1
    return out


def _paste_model(wy, masks, wxt, thresh):
    """The band pass: per (detection, band), the in-box rectangle (band rows
    inside [r0, r1) x the 16-pixel words covering [c0, c1)); every (row,
    word) outside it stored as the constant; the rectangle's words computed
    chunk by chunk from staged wxt columns (zero outside [c0, c1)), and a
    word's pixels outside [c0, c1) set to the constant.  Returns (canvas,
    times each pixel was written, pixels computed, extents)."""
    n, h, _ = wy.shape
    w = wxt.shape[2]
    zb = 0.0 > thresh
    out = np.zeros((n, h, w), bool)
    writes = np.zeros((n, h, w), np.int64)
    computed = np.zeros((n, h, w), bool)
    ext = _extent_model(wy, wxt)
    for i in range(n):
        c0, c1, r0, r1 = ext[i]
        for h0 in range(0, h, BAND):
            rows = min(BAND, h - h0)
            ri0, ri1 = max(r0, h0) - h0, min(r1, h0 + rows) - h0
            any_row = c0 < c1 and r0 < r1 and ri0 < ri1
            u0, u1 = (c0 // WORD, -(-c1 // WORD)) if any_row else (0, 0)
            rect = np.zeros((rows, w), bool)
            if any_row:
                rect[ri0:ri1, u0 * WORD:u1 * WORD] = True
            out[i, h0:h0 + rows][~rect] = zb
            writes[i, h0:h0 + rows][~rect] += 1
            if not any_row:
                continue
            rr = np.arange(h0 + ri0, h0 + ri1)
            t1 = wy[i, rr] @ masks[i]  # (in-box rows, M)
            for uc in range(u0, u1, CHUNK_WORDS):
                cols = np.arange(uc * WORD, (uc + CHUNK_WORDS) * WORD)
                valid = (cols >= c0) & (cols < c1)
                staged = np.where(valid, wxt[i][:, np.minimum(cols, w - 1)], 0.0)
                for wi in range(min(CHUNK_WORDS, u1 - uc)):
                    cs = cols[wi * WORD:(wi + 1) * WORD]
                    acc = t1 @ staged[:, wi * WORD:(wi + 1) * WORD]
                    bits = np.where((cs >= c0) & (cs < c1), acc > thresh, zb)
                    keep = cs < w
                    out[i][np.ix_(rr, cs[keep])] = bits[:, keep]
                    writes[i][np.ix_(rr, cs[keep])] += 1
                    computed[i][np.ix_(rr, cs[keep])] = True
    return out, writes, computed, ext


def _edge_dets(seed, n, canvas, m=21):
    """_dets plus boxes wholly outside, of 1 px, over the full canvas and
    beyond it, on its edges, and straddling 16-pixel words."""
    masks, boxes = _dets(seed, n, m)
    h, w = canvas
    special = np.array([[-500, -500, -300, -300], [w + 100, 10, w + 300, 30],
                        [10, h + 50, 30, h + 90], [7, 7, 7, 7], [20.5, 10.25, 20.5, 10.25],
                        [0, 0, w - 1, h - 1], [-40, -40, w + 40, h + 40],
                        [w - 1, h - 1, w - 1, h - 1], [13, 3, 35, h - 9],
                        [3, 31, w - 4, 33]], np.float32)
    boxes[:len(special)] = special
    return masks, boxes


@pytest.mark.parametrize("canvas", [(96, 128), (40, 50), (70, 203)])
@pytest.mark.parametrize("thresh", [0.4, -0.1])
def test_paste_kernel_model_matches_plain_and_pallas(canvas, thresh):
    """The model of kernel C: every pixel written exactly once, only pixels
    of the in-box rectangle computed, boxes outside the canvas with an empty
    extent, and the canvas equal to paste_binarize_plain and to the Pallas
    kernel (interpret mode) except within 1e-6 of the threshold; with a
    negative threshold the pixels outside the box are True."""
    h, w = canvas
    masks, boxes = _edge_dets(11, 24, canvas)
    tb = torch.from_numpy(boxes)
    wy = _paste_axis_weights(tb[:, 1], tb[:, 3], 21, h)
    wxt = _paste_axis_weights(tb[:, 0], tb[:, 2], 21, w).transpose(1, 2).contiguous()
    got, writes, computed, ext = _paste_model(wy.numpy(), masks, wxt.numpy(), thresh)
    assert (writes == 1).all()
    rows_in = (wy != 0).any(-1).numpy()
    cols_in = (wxt != 0).any(-2).numpy()
    assert not (computed & ~rows_in[:, :, None]).any()  # only in-box rows are computed
    for i in range(len(boxes)):  # the extents are the in-box column and row ranges
        for k, nz in enumerate((cols_in[i], rows_in[i])):
            idx = np.flatnonzero(nz)
            assert tuple(ext[i, 2 * k:2 * k + 2]) == ((idx[0], idx[-1] + 1) if len(idx)
                                                      else (0, 0))
            assert nz[ext[i, 2 * k]:ext[i, 2 * k + 1]].all()  # in-box ranges are contiguous
    assert tuple(ext[0]) == (0, 0, 0, 0) and tuple(ext[1, :2]) == (0, 0)
    assert tuple(ext[2, 2:]) == (0, 0)
    assert tuple(ext[5]) == (0, w, 0, h) and ext[3, 1] - ext[3, 0] == 1
    # a word that straddles c0 and c1 exists, and its outside pixels are the constant
    straddle = [i for i in range(len(boxes)) if ext[i, 0] % WORD or ext[i, 1] % WORD]
    assert straddle
    outside = ~(rows_in[:, :, None] & cols_in[:, None, :])
    assert (got[outside] == (0.0 > thresh)).all()
    prod = torch.bmm(torch.bmm(wy, torch.from_numpy(masks)), wxt).numpy()
    plain = paste_binarize_plain(wy, torch.from_numpy(masks), wxt, thresh).numpy()
    _assert_canvas_match(got, plain, prod, thresh, 1e-6)
    pallas = np.asarray(paste_binarize_pallas(jnp.asarray(wy.numpy()), jnp.asarray(masks),
                                              jnp.asarray(wxt.numpy()), thresh))
    _assert_canvas_match(got, pallas, prod, thresh, 1e-6)


def _vote_case(seed, n=6, cv=10, m=21):
    rs = np.random.RandomState(seed)
    kept = np.stack([rs.uniform(0, 50, n), rs.uniform(0, 40, n)], 1)
    kept = np.concatenate([kept, kept + rs.uniform(10, 40, (n, 2))], 1).astype(np.float32)
    cand = kept[:, None, :] + rs.uniform(-8, 8, (n, cv, 4)).astype(np.float32)
    scores = rs.uniform(size=(n, cv)).astype(np.float32)
    scores[:, -2:] = 0.0  # ignored entries
    masks = rs.uniform(size=(n, cv, m, m)).astype(np.float32)
    return kept, cand, scores, masks


def test_mask_voting_per_det_matches_jax():
    kept, cand, scores, masks = _vote_case(0)
    want = np.asarray(j_mask_voting_per_det(*map(jnp.asarray, (kept, cand, scores,
                                                                 masks)), 0.5))
    got = mv.mask_voting_per_det(*map(torch.from_numpy, (kept, cand, scores, masks)), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_box_voting_per_det_matches_jax():
    kept, cand, scores, _ = _vote_case(1)
    want = np.asarray(j_box_voting_per_det(*map(jnp.asarray, (kept, cand, scores)),
                                             0.5))
    got = mv.box_voting_per_det(*map(torch.from_numpy, (kept, cand, scores)), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_mask_voting_golden():
    g = np.load(os.path.join(GOLDEN, "mask_voting.npz"))
    n, k = len(g["kept"]), len(g["cand"])
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    merged = mv.mask_voting_per_det(
        t(g["kept"]), t(g["cand"]).expand(n, k, 4), t(g["scores"]).expand(n, k),
        t(g["masks"]).expand(n, k, *g["masks"].shape[1:]), 0.5)
    np.testing.assert_allclose(merged.numpy(), g["merged"], rtol=1e-4, atol=1e-5)
