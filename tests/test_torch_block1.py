"""The port's fused VGG block 1 on the CPU: ``block1_plain`` (the plain twin of
kernel D) against the JAX package's ``block1_reference`` and against its
Pallas kernel ``fused_block1`` in interpret mode, and
``VGG16Trunk(fused_block1=True)`` against the JAX trunk with the same flag.

Tolerance: at most 1 bf16 ulp at every element, as the JAX package's own
test states it: |diff| <= 2^-7 * max(|reference|, 1); the border rows and
columns are checked on their own.  The trunk comparison allows rtol 0.15 /
atol 0.05 (1-ulp deviations pass through 11 more bf16 layers), as
``tests/test_block1_kernel.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.vgg import VGG16Trunk as JTrunk
from mnc_tpu.ops.pallas.block1_kernel import block1_reference
from mnc_tpu.ops.pallas.block1_kernel import fused_block1 as j_fused_block1
from mnc_tpu_torch.models.vgg import VGG16Trunk
from mnc_tpu_torch.ops.block1 import (CHANNEL_OF_COLUMN, block1_plain, block1_tolerance,
                                      conv_relu_plain, fused_block1, pack_block1_weights,
                                      packed_block1_weights)
from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax

BF16_ULP = 2.0 ** -7


def _params(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(3, 3, 3, 64).astype(np.float32) * 0.1, rs.randn(64).astype(np.float32),
            rs.randn(3, 3, 64, 64).astype(np.float32) * 0.05, rs.randn(64).astype(np.float32))


def _plain(x, p):
    w1, b1, w2, b2 = p  # HWIO -> OIHW
    oihw = lambda w: torch.tensor(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    return block1_plain(torch.tensor(x), oihw(w1), torch.tensor(b1), oihw(w2),
                        torch.tensor(b2)).float().numpy()


def _assert_ulp_close(got, ref):
    d = np.abs(got - ref)
    tol = BF16_ULP * np.maximum(np.abs(ref), 1.0)
    assert (d <= tol).all(), f"max dev {d.max()} vs tol {tol.flat[d.argmax()]}"
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert (d[edge] <= tol[edge]).all()


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 16, 40, 3)])
def test_block1_plain_matches_reference_and_pallas(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32) * 50
    p = _params(7)
    got = _plain(x, p)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    ref = np.asarray(block1_reference(jnp.asarray(x), *map(jnp.asarray, p)), np.float32)
    _assert_ulp_close(got, ref)
    pallas = np.asarray(j_fused_block1(jnp.asarray(x), *map(jnp.asarray, p), 2), np.float32)
    _assert_ulp_close(got, pallas)


def test_block1_plain_edge_zero_padding():
    """conv1_2 pads conv1_1's OUTPUT with zeros: a constant image makes a
    halo mistake (relu(b1) leaking in) visible at the borders."""
    p = _params(3)
    x = np.full((1, 16, 16, 3), 7.0, np.float32)
    ref = np.asarray(block1_reference(jnp.asarray(x), *map(jnp.asarray, p)), np.float32)
    _assert_ulp_close(_plain(x, p), ref)


def test_block1_plain_gradients_match_reference_vjp():
    rs = np.random.RandomState(5)
    p = _params(5)
    x = rs.randn(1, 16, 16, 3).astype(np.float32)

    def jloss(x, *p):
        return jnp.sum(block1_reference(x, *p).astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *map(jnp.asarray, p))
    w1, b1, w2, b2 = p
    args = [torch.tensor(x), torch.tensor(w1.transpose(3, 2, 0, 1).copy()), torch.tensor(b1),
            torch.tensor(w2.transpose(3, 2, 0, 1).copy()), torch.tensor(b2)]
    for a in args:
        a.requires_grad_()
    (fused_block1(*args).float() ** 2).sum().backward()
    got = [args[0].grad, args[1].grad.permute(2, 3, 1, 0), args[2].grad,
           args[3].grad.permute(2, 3, 1, 0), args[4].grad]
    for g, w in zip(got, want):
        # the JAX backward runs in bf16 and rounds every intermediate; the
        # plain twin's runs in f32: 10% of each gradient's max
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=0.05,
                                   atol=0.1 * np.abs(np.asarray(w, np.float32)).max())


def _bridged_trunks(x, **kw):
    jt = JTrunk(**kw)
    params = JTrunk().init(jax.random.PRNGKey(0), jnp.asarray(x))
    trunk = VGG16Trunk(torch.bfloat16, frozen_blocks=0, fused_block1=kw.get("fused_block1",
                                                                             False))
    sd = state_dict_from_jax({"params": {"trunk": params["params"]}})
    trunk.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jt, params, trunk


def test_trunk_fused_block1_matches_jax_trunk():
    rs = np.random.RandomState(1)
    x = rs.randn(1, 16, 32, 3).astype(np.float32) * 10
    jt, params, trunk = _bridged_trunks(x, fused_block1=True)
    want = np.asarray(jt.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = trunk(torch.tensor(x)).float().numpy()
        unfused = VGG16Trunk(torch.bfloat16, 0, False)
        unfused.load_state_dict(trunk.state_dict())
        base = unfused(torch.tensor(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.15, atol=0.05)
    np.testing.assert_allclose(got, base, rtol=0.15, atol=0.05)


def test_trunk_fused_block1_shape_rule():
    """H % 8 != 0 takes the unfused layers: the same program, bit for bit.
    The rule looks at the shape only."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 20, 16, 3).astype(np.float32)
    _, _, trunk = _bridged_trunks(x, fused_block1=True)
    unfused = VGG16Trunk(torch.bfloat16, 0, False)
    unfused.load_state_dict(trunk.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(trunk(torch.tensor(x)).float().numpy(),
                                      unfused(torch.tensor(x)).float().numpy())


# ---- kernel D (csrc/block1.cu), modelled step by step
TR, TC = 4, 64                      # conv1_2 tile
OR_, OC = TR + 2, TC + 2            # conv1_1 tile
OPIX = OR_ * OC
IR, IC = TR + 4, TC + 4             # input tile
IWORDS = IC * 3 // 2                # 32-bit words of an input row
SMS = 132                           # persistent blocks: one per SM of an H100


def _tiles(b, h, w):
    ty, tx = -(-h // TR), -(-w // TC)
    return b * ty * tx, tx, ty


def _tile_of(t, tiles_x, tiles_y):
    tx, rest = t % tiles_x, t // tiles_x
    return rest // tiles_y, (rest % tiles_y) * TR, tx * TC


def _schedule(b, h, w, grid=SMS):
    """[(block, it, tile)]: the tiles each persistent block walks, in order."""
    n, tiles_x, tiles_y = _tiles(b, h, w)
    grid = min(n, grid)
    return [(blk, it, _tile_of(t, tiles_x, tiles_y))
            for blk in range(grid) for it, t in enumerate(range(blk, n, grid))]


def _lane_stores(y0, x0):
    """Consumer epilogue: (pooled row, pooled column, channel quarter q) of
    every lane of the two consumer warpgroups (cg, warp w, g = lane / 4)."""
    cg, w, g, q = np.meshgrid(range(2), range(4), range(8), range(4), indexing="ij")
    px = x0 // 2 + 8 * w + np.where(g % 2 == 0, g // 2, 4 + (g - 1) // 2)
    return (y0 // 2 + cg).ravel(), px.ravel(), q.ravel()


@pytest.mark.parametrize("b,h,w", [(2, 640, 1024), (4, 640, 1024), (1, 40, 50), (1, 24, 18),
                                   (3, 22, 130)])
def test_block1_tile_schedule_covers_every_output_once(b, h, w):
    """Every pooled output channel is stored by exactly one lane of one tile
    of one persistent block; each block alternates its two conv1_1 buffers
    and waits on the k-th hand-off of a buffer for its (2k + buf)-th tile."""
    sched = _schedule(b, h, w)
    counts = np.zeros((b, h // 2, w // 2, 4), np.int64)
    for blk, it, (bi, y0, x0) in sched:
        py, px, q = _lane_stores(y0, x0)
        ok = (py < h // 2) & (px < w // 2)
        np.add.at(counts, (bi, py[ok], px[ok], q[ok]), 1)
    assert (counts == 1).all()
    by_block = {}
    for blk, it, _ in sched:
        by_block.setdefault(blk, []).append(it)
    for its in by_block.values():
        assert its == list(range(len(its)))
        # consumer waits full[it & 1] at parity (it >> 1) & 1: the (it >> 1)-th fill
        fills = {0: 0, 1: 0}
        for it in its:
            assert it >> 1 == fills[it & 1]
            fills[it & 1] += 1
    assert len(by_block) == min(SMS, _tiles(b, h, w)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block1_weight_packing_round_trips(dtype):
    """pack_block1_weights' layouts hold every weight once: w1p unpacks to
    HWIO, w2p's swizzled, column-permuted B tiles unpack to HWIO, and each
    accumulator lane q's columns 8j + 2q + e hold channels 16q + 2j + e."""
    g = torch.Generator().manual_seed(3)
    w1 = torch.randn(64, 3, 3, 3, generator=g).to(dtype)
    w2 = torch.randn(64, 64, 3, 3, generator=g).to(dtype)
    b1, b2 = torch.randn(64, generator=g), torch.randn(64, generator=g)
    w1p, b1p, w2p, b2p = pack_block1_weights(w1, b1, w2, b2)
    assert w1p.shape == (64, 32) and w2p.shape == (9, 64, 64)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (w1p, b1p, w2p, b2p))
    assert not w1p[:, 27:].any()
    bf = torch.bfloat16
    u1 = w1p[:, :27].reshape(64, 3, 3, 3).permute(1, 2, 3, 0)  # [co][ky, kx, ci] -> HWIO
    assert torch.equal(u1, w1.to(bf).permute(2, 3, 1, 0))
    # w2p[tap] row n, input channel ci: 16-byte chunk ci / 8 stored at (ci / 8) ^ (n % 8)
    u2 = torch.empty(3, 3, 64, 64, dtype=bf)
    flat = w2p.reshape(9, 64 * 64)
    for n in range(64):
        for ci in range(64):
            u2[:, :, ci, CHANNEL_OF_COLUMN[n]] = flat[:, n * 64 + ((ci // 8) ^ (n % 8)) * 8
                                                     + ci % 8].reshape(3, 3)
    assert torch.equal(u2, w2.to(bf).permute(2, 3, 1, 0))
    assert sorted(CHANNEL_OF_COLUMN.tolist()) == list(range(64))
    for q in range(4):
        cols = [8 * j + 2 * q + e for j in range(8) for e in range(2)]
        assert CHANNEL_OF_COLUMN[cols].tolist() == list(range(16 * q, 16 * q + 16))


def test_block1_packing_cache_is_refreshed_in_place():
    """The packing is cached per weight version: the same call returns the
    same tensors, an in-place update (an optimizer step) repacks, and another
    tensor at the same address is not mistaken for the first."""
    g = torch.Generator().manual_seed(4)
    w1 = torch.nn.Parameter(torch.randn(64, 3, 3, 3, generator=g))
    w2 = torch.nn.Parameter(torch.randn(64, 64, 3, 3, generator=g))
    b1, b2 = torch.randn(64, generator=g), torch.randn(64, generator=g)
    first = packed_block1_weights(w1, b1, w2, b2)
    assert packed_block1_weights(w1, b1, w2, b2) is first
    with torch.no_grad():
        w2.mul_(2.0)
    second = packed_block1_weights(w1, b1, w2, b2)
    assert second is not first
    assert torch.equal(second[2], pack_block1_weights(w1, b1, w2, b2)[2])
    b1.add_(1.0)
    third = packed_block1_weights(w1, b1, w2, b2)
    assert torch.equal(third[1], b1.to(torch.bfloat16))
    alias = w1.detach()  # shares storage and version counter, another object
    assert packed_block1_weights(alias, b1, w2, b2) is not third


def test_block1_packing_of_inference_tensors_follows_in_place_updates():
    """Weights made under torch.inference_mode have no version counter; their
    packing is not cached, so an in-place load there is seen."""
    with torch.inference_mode():
        g = torch.Generator().manual_seed(6)
        w1, w2 = torch.randn(64, 3, 3, 3, generator=g), torch.randn(64, 64, 3, 3, generator=g)
        b1, b2 = torch.randn(64, generator=g), torch.randn(64, generator=g)
        first = packed_block1_weights(w1, b1, w2, b2)
        w2.copy_(torch.randn(64, 64, 3, 3, generator=g))
        second = packed_block1_weights(w1, b1, w2, b2)
        assert torch.equal(second[2], pack_block1_weights(w1, b1, w2, b2)[2])
        assert not torch.equal(second[2], first[2])


def _bf(t):
    return t.to(torch.bfloat16).float()


def _bias_relu2(lo, hi, blo, bhi):
    """csrc/block1.cu bias_relu2 on two value arrays: round both, add the bf16
    biases in f32, round again with the ReLU."""
    return _bf(torch.relu(_bf(lo) + blo)), _bf(torch.relu(_bf(hi) + bhi))


def _o1_offset(p, chunk):
    return p * 128 + ((chunk ^ (p & 7)) << 4)


def _kernel_d_model(x, w1, b1, w2, b2):
    """block1_kernel step by step on the CPU, in f32 on bf16 values: the
    producer's cp.async words, im2col offsets and mma.sync fragments (placed
    by the PTX m16n8k16 layouts), its epilogue into the swizzled conv1_1
    tile; the consumers' ldmatrix addresses (placed by the ldmatrix and
    wgmma register-A layouts), the B tiles as a 128-byte-swizzle K-major
    descriptor reads the packed weights, the two-row accumulators, and the
    register epilogue with its lane exchange and channel order."""
    bsz, h, w, _ = x.shape
    w1p, b1p, w2p, b2p = pack_block1_weights(w1, b1, w2, b2)
    xf = x.to(torch.bfloat16).float().reshape(-1)
    w1f, w2s = w1p.float().reshape(-1), w2p.float().reshape(-1)
    b1f, b2f = b1p.float(), b2p.float()
    out = torch.full((bsz, h // 2, w // 2, 64), float("nan"))
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    # the lane's im2col columns k = 16 ks + 2q + (i & 1) + (i >> 1) * 8
    koff = np.zeros((2, 4, 32), np.int64)
    kvalid = np.zeros((2, 4, 32), bool)
    for ks in range(2):
        for i in range(4):
            k = 16 * ks + 2 * q + (i & 1) + (i >> 1) * 8
            tap, ci = k // 3, k % 3
            kvalid[ks, i] = k < 27
            koff[ks, i] = np.where(k < 27, ((tap // 3) * IC + tap % 3) * 3 + ci, 0)
    # w1 B fragments by ldmatrix.x4 from w1p's rows: lane l points at row
    # 8j + (l & 7), k 8 (l >> 3); register i of lane t is matrix i's row t / 4,
    # elements 2 (t % 4) + e, which the m16n8k16 B layout places at
    # k = 16 (i / 2) + 8 (i % 2) + 2q + e, n = 8j + g
    w1img = w1f.reshape(64, 32)
    bmat = torch.zeros(32, 64)
    for j in range(8):
        mats = torch.zeros(4, 8, 8)
        for ln in range(32):
            mats[ln >> 3, ln & 7] = w1img[8 * j + (ln & 7), 8 * (ln >> 3):8 * (ln >> 3) + 8]
        for i in range(4):
            for e in range(2):
                bmat[16 * (i // 2) + 8 * (i % 2) + 2 * q + e, 8 * j + g] = \
                    mats[i, g, 2 * q + e]

    def b_tile(tap, kc):  # B (16 x 64) as the descriptor reads it
        k, n = np.meshgrid(np.arange(16), np.arange(64), indexing="ij")
        addr = tap * 8192 + 32 * kc + n * 128 + (k // 8) * 16 + (k % 8) * 2
        phys = addr ^ (((addr >> 7) & 7) << 4)
        return w2s[phys // 2]

    btiles = {(t, kc): b_tile(t, kc) for t in range(9) for kc in range(4)}
    for _, _, (bi, y0, x0) in _schedule(bsz, h, w):
        # ---- producer: the input tile, word by word
        xin = torch.zeros(IR * IC * 3)
        for i in range(IR * IWORDS):
            r, wd = divmod(i, IWORDS)
            gy, gx = y0 - 2 + r, x0 - 2 + (2 * wd) // 3
            if 0 <= gy < h and 0 <= gx < w:
                src = ((bi * h + gy) * w + (x0 - 2)) * 3 + 2 * wd
                xin[2 * i:2 * i + 2] = xf[src:src + 2]
        o1 = torch.zeros(OPIX * 64)  # bf16 values, indexed by byte offset / 2
        for mt in range((OPIX + 15) // 16):
            amat = torch.zeros(16, 32)
            base = []
            for hh in range(2):
                pc = np.minimum(mt * 16 + g + 8 * hh, OPIX - 1)
                base.append(((pc // OC) * IC + pc % OC) * 3)
            for ks in range(2):
                for r in range(4):  # a0: (g, k lo), a1: (g + 8, k lo), a2: (g, k hi), a3
                    hh, i = r & 1, (r >> 1) * 2
                    for e in range(2):
                        v = torch.where(torch.from_numpy(kvalid[ks, i + e]),
                                        xin[base[hh] + koff[ks, i + e]], 0.0)
                        amat[g + 8 * (r & 1), 16 * ks + 8 * (r >> 1) + 2 * q + e] = v
            cmat = amat @ bmat  # (16 pixels, 64 channels), f32
            for hh in range(2):
                p = mt * 16 + g + 8 * hh
                for j in range(8):
                    for ln in range(32):
                        if p[ln] >= OPIX:
                            continue
                        rr, cc = divmod(int(p[ln]), OC)
                        inside = 0 <= y0 - 1 + rr < h and 0 <= x0 - 1 + cc < w
                        ch = 8 * j + 2 * q[ln]
                        lo, hi = _bias_relu2(cmat[g[ln] + 8 * hh, ch], cmat[g[ln] + 8 * hh, ch + 1],
                                             b1f[ch], b1f[ch + 1])
                        off = (_o1_offset(int(p[ln]), j) + 4 * int(q[ln])) // 2
                        o1[off:off + 2] = torch.stack([lo, hi]) if inside else 0.0
        # ---- consumers: two rows x 64 pixels each
        for cg in range(2):
            acc = [torch.zeros(64, 64), torch.zeros(64, 64)]
            for s in range(4):
                for dx in range(3):
                    for kc in range(4):
                        amat = torch.zeros(64, 16)
                        for wq in range(4):  # warp: ldmatrix.x4, lane l gives row l & 15
                            for ln in range(32):
                                p = (2 * cg + s) * OC + 16 * wq + (ln & 15) + dx
                                start = _o1_offset(p, 2 * kc + (ln >> 4)) // 2
                                # matrix ln // 8, row ln % 8 -> A row 16 wq + (ln & 15),
                                # columns 8 (ln >> 4) .. + 7 of this k16 step
                                amat[16 * wq + (ln & 15), 8 * (ln >> 4):8 * (ln >> 4) + 8] = \
                                    o1[start:start + 8]
                        if s <= 2:
                            acc[0] += amat @ btiles[(s * 3 + dx, kc)]
                        if s >= 1:
                            acc[1] += amat @ btiles[((s - 1) * 3 + dx, kc)]
            m = torch.maximum(acc[0], acc[1])
            for wq in range(4):
                for ln in range(32):
                    gg, qq = ln // 4, ln % 4
                    even = gg % 2 == 0
                    cols = [8 * j + 2 * qq + e for j in range(8) for e in range(2)]
                    row_lo, row_hi = 16 * wq + gg, 16 * wq + gg + 8
                    mine = m[row_lo if even else row_hi, cols]
                    partner = 16 * wq + (gg ^ 1) + (8 if not even else 0)
                    v = torch.maximum(mine, m[partner, cols])
                    py = y0 // 2 + cg
                    px = x0 // 2 + 8 * wq + (gg // 2 if even else 4 + (gg - 1) // 2)
                    if py < h // 2 and px < w // 2:
                        chans = CHANNEL_OF_COLUMN[cols]
                        assert chans.tolist() == list(range(16 * qq, 16 * qq + 16))
                        lo, hi = _bias_relu2(v[0::2], v[1::2], b2f[chans[0::2]],
                                             b2f[chans[1::2]])
                        out[bi, py, px, chans[0::2]] = lo
                        out[bi, py, px, chans[1::2]] = hi
    return out


@pytest.mark.parametrize("shape,const", [((1, 40, 50, 3), None), ((1, 24, 18, 3), 7.0),
                                         ((2, 10, 130, 3), None)])
def test_block1_kernel_model_matches_plain(shape, const):
    """The step-by-step model of kernel D meets the card's criteria against
    block1_plain: every element within block1_tolerance, >= 0.999 of them
    bit-identical; on ragged tiles (H % 4 == 2, W % 64 != 0) and a constant
    image (zero padding of conv1_1's output)."""
    g = torch.Generator().manual_seed(8)
    w1 = torch.randn(64, 3, 3, 3, generator=g) * 0.1
    b1 = torch.randn(64, generator=g)
    w2 = torch.randn(64, 64, 3, 3, generator=g) * 0.05
    b2 = torch.randn(64, generator=g)
    x = (torch.randn(shape, generator=g) * 50 if const is None
         else torch.full(shape, const))
    got = _kernel_d_model(x, w1, b1, w2, b2)
    want = block1_plain(x, w1, b1, w2, b2).float()
    assert not torch.isnan(got).any()
    o1_max = conv_relu_plain(x.to(torch.bfloat16).permute(0, 3, 1, 2), w1, b1).float().max()
    assert ((got - want).abs() <= block1_tolerance(want, o1_max.item(), w2, b2)).all()
    assert (got == want).float().mean().item() >= 0.999
