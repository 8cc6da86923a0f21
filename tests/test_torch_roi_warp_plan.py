"""Kernel A's host side on the CPU: its plan (``kernels.plan_roi_warp``), its
taps (``kernels.roi_warp_taps``), the L2 byte counts ``chip_smoke.py``
prints, and the arguments its wrapper hands the C entry point.  The kernel
itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The plan and the taps are held by an emulation of the kernel in plain
PyTorch (``emulate_kernel``): per (image, RoI chunk, slab) unit, the map
slab staged band by band, each band's tap table (row offsets into the
staged rows, zero weight outside the map, a bin only in the band that holds
both its row taps), four taps per bin read by offset.  It must reproduce
``roi_warp_plain``, and through it the JAX package's ``_warp_einsum``, within
the f32 tolerance of the port's warp tests (1e-5 of max|F|: the same linear
map, summed in another order).
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.ops.roi_warp import _warp_einsum
from mnc_tpu_torch import kernels
from mnc_tpu_torch.kernels import _build
from mnc_tpu_torch.ops.roi_warp import roi_warp_plain
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

CANVAS = (640, 1024)
MAP = (40, 64)  # the canvas at stride 16
SCALE = 1.0 / 16


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n", [0, 1, 128, 300, 304])
def test_plan_covers_every_item_once(b, n):
    plan = kernels.plan_roi_warp(b, n, 512, torch.bfloat16, (14, 14), MAP)
    seen = {}
    for g, img, roi, slab in plan.work():
        assert 0 <= g < plan.grid
        assert (img, roi, slab) not in seen, f"item {(img, roi, slab)} twice"
        seen[img, roi, slab] = g
    assert set(seen) == {(i, r, s) for i in range(b) for r in range(n)
                         for s in range(plan.slabs)}
    assert plan.slabs == 16 and plan.bands == 1 and plan.grid <= 132
    if n:  # every block has a unit; the units fill the card without a second wave
        assert set(seen.values()) == set(range(plan.grid))
        assert plan.units == plan.grid
        assert plan.units > 132 - b * plan.slabs or plan.chunks == n
        # a unit's RoIs are one contiguous chunk of one image, at one slab
        for g in range(plan.grid):
            items = [k for k, v in seen.items() if v == g]
            assert len({(i, s) for i, _, s in items}) == 1
            rois = sorted(r for _, r, _ in items)
            assert rois == list(range(rois[0], rois[0] + len(rois)))
            assert len(rois) <= plan.chunk


def test_plan_units_of_the_main_shapes():
    """128 units of one block an SM at every shape of the main path: the
    serving request, the ResNet map, CFM's segments, a train step."""
    for (b, n), c, dtype, chunks in (((4, 304), 512, torch.bfloat16, 2),
                                     ((4, 304), 1024, torch.bfloat16, 1),
                                     ((4, 304), 512, torch.float32, 1),
                                     ((1, 300), 512, torch.bfloat16, 8),
                                     ((2, 128), 512, torch.bfloat16, 4)):
        plan = kernels.plan_roi_warp(b, n, c, dtype, (14, 14), MAP)
        assert (plan.cell_chunks, plan.chunks, plan.units, plan.grid) == (4, chunks, 128, 128)
        assert plan.blocks_per_sm == 1 and plan.staged_bytes() == 128 * 40 * 64 * 64


@pytest.mark.parametrize("c", [512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("map_hw", [MAP, MAP[::-1]])
def test_plan_shared_memory_holds_the_map_slab(c, dtype, map_hw):
    """A whole 40 x 64 (or portrait 64 x 40) map slab of 64-byte cells and
    the tap tables of a batch fit one block's 227 KB; every RoI of the
    canvas then reads only staged cells."""
    plan = kernels.plan_roi_warp(4, 304, c, dtype, (14, 14), map_hw)
    assert plan.smem <= kernels.H100_SMEM_PER_BLOCK
    assert plan.smem == 40 * 64 * 64 + kernels.ROI_WARP_ROIS * 28 * 16
    assert (plan.band_rows, plan.bands) == (map_hw[0], 1)
    assert plan.cell_chunks * 16 == 64 and plan.slab * dtype.itemsize == 64


def test_plan_narrow_channels_bands_and_limits():
    # 24 bf16 channels: three vectors, cells of one 16-byte chunk
    plan = kernels.plan_roi_warp(2, 37, 24, torch.bfloat16, (7, 5), (12, 16))
    assert (plan.cell_chunks, plan.slabs, plan.bands) == (1, 3, 1)
    # a small map takes 128-byte cells
    plan = kernels.plan_roi_warp(2, 37, 64, torch.bfloat16, (7, 5), (12, 16))
    assert (plan.cell_chunks, plan.slabs) == (8, 1)
    # a map too large for shared memory goes in bands of rows
    plan = kernels.plan_roi_warp(1, 5, 512, torch.bfloat16, (14, 14), (200, 150))
    assert plan.cell_chunks == 1 and plan.bands == -(-200 // plan.band_rows) > 1
    assert plan.smem <= kernels.H100_SMEM_PER_BLOCK
    assert kernels.roi_warp_smem(1, plan.band_rows + 1, (200, 150), (14, 14)) > \
        kernels.H100_SMEM_PER_BLOCK
    plan = kernels.plan_roi_warp(4, 304, 512, torch.bfloat16, (14, 14), MAP, band_rows=13)
    assert (plan.band_rows, plan.bands, plan.cell_chunks) == (13, 4, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.plan_roi_warp(1, 3, 20, torch.bfloat16, (14, 14), MAP)
    with pytest.raises(ValueError, match="two rows"):
        kernels.plan_roi_warp(1, 3, 8, torch.float32, (14, 14), (4, 20000))


def _box_set(rs, n, canvas):
    """Random boxes of 16-500 px, boxes whose bin centers are integers,
    1-12 px boxes on a few cells, and boxes over the map's edges."""
    h, w = canvas
    cx, cy = rs.uniform(0, w, n), rs.uniform(0, h, n)
    bw, bh = rs.uniform(16, 500, n), rs.uniform(16, 500, n)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    c = 300.0 + rs.uniform(0, 64, (n, 2))
    half = 0.5 + rs.uniform(0, 5.5, (n, 2))
    small = np.concatenate([c - half, c + half], 1)
    special = np.array([[32.0, 16.0, 255.0, 239.0],  # integer bin centers
                        [-16.0, 496.0, 207.0, 719.0],  # integer centers over the edge
                        [0.0, 0.0, w - 1.0, h - 1.0],  # the full canvas
                        [100.0, 100.0, 100.0, 100.0],  # 1 px
                        [-500.0, -500.0, -300.0, -300.0],  # wholly outside
                        [w + 900.0, 100.0, w + 1000.0, 200.0],
                        [-40.0, -40.0, 60.0, 60.0],  # over a corner
                        [-30.0, 200.0, w + 30.0, 215.0]])  # wider than the map
    return np.concatenate([boxes, small, special]).astype(np.float32)


def emulate_kernel(feat: torch.Tensor, rois: torch.Tensor, out_hw, plan) -> torch.Tensor:
    """Kernel A in plain PyTorch under ``plan``: feat (B, H, W, C) f32, rois
    (B, N, 4) → (B, N, PH, PW, C); every output element written once, by the
    unit and band the kernel computes it in."""
    ph, pw = out_hw
    b, h, w, c = feat.shape
    out = torch.full((b, rois.shape[1], ph, pw, c), float("nan"))
    yi, wy0, wy1 = kernels.roi_warp_taps(rois, ph, SCALE, h, 0)
    xi, wx0, wx1 = kernels.roi_warp_taps(rois, pw, SCALE, w, 1)
    units = {}
    for _, img, roi, slab in plan.work():
        units.setdefault((img, slab), []).append(roi)
    for (img, slab), rois_of_unit in units.items():
        chans = slice(slab * plan.slab, (slab + 1) * plan.slab)
        for band in range(plan.bands):
            y_lo = band * plan.band_rows
            staged = feat[img, y_lo:y_lo + plan.band_rows + 1, :, chans]  # the band's rows
            for n in rois_of_unit:
                own = yi[img, n].clamp(0, h - 1) // plan.band_rows == band  # (PH,)
                for p in range(ph):
                    if not own[p]:
                        continue
                    for q in range(pw):
                        acc = torch.zeros(plan.slab)
                        for dy, wy in ((0, wy0), (1, wy1)):
                            for dx, wx in ((0, wx0), (1, wx1)):
                                wgt = wy[img, n, p] * wx[img, n, q]
                                if wgt != 0:
                                    acc += wgt * staged[yi[img, n, p] + dy - y_lo,
                                                        xi[img, n, q] + dx]
                        assert bool(out[img, n, p, q, chans].isnan().all())
                        out[img, n, p, q, chans] = acc
    return out


@pytest.mark.parametrize("out_hw,band_rows", [((14, 14), None), ((7, 5), None),
                                              ((2, 2), None), ((7, 5), 13)])
def test_emulation_matches_plain_and_jax(out_hw, band_rows):
    rs = np.random.RandomState(7)
    b, n, c = 2, 12, 16
    feat = rs.randn(b, *MAP, c).astype(np.float32)
    rois = np.stack([_box_set(rs, n, CANVAS)[rs.choice(2 * n + 8, n, replace=False)]
                     for _ in range(b)])
    rois[0, :8] = _box_set(rs, 0, CANVAS)  # every edge case in image 0
    ft, rt = torch.from_numpy(feat), torch.from_numpy(rois)
    plan = kernels.plan_roi_warp(b, n, c, torch.float32, out_hw, MAP, cell_chunks=2,
                                 band_rows=band_rows)
    assert plan.slabs == 2 and plan.bands == (1 if band_rows is None else 4)
    got = emulate_kernel(ft, rt, out_hw, plan)
    tol = 1e-5 * np.abs(feat).max()
    np.testing.assert_allclose(got.numpy(), roi_warp_plain(ft, rt, out_hw, SCALE).numpy(),
                               rtol=0, atol=tol)
    for i in range(b):
        want = np.asarray(_warp_einsum(jnp.asarray(feat[i]), jnp.asarray(rois[i]), out_hw,
                                       SCALE))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=tol)
    # the RoIs wholly outside the map read nothing and give zeros
    assert float(got[0, 4].abs().max()) == 0.0 and float(got[0, 5].abs().max()) == 0.0


def test_taps_integer_centers_and_edges():
    """A box whose bin centers are integers weighs each bin's second tap 0;
    a tap outside the map weighs 0; the weights are the plain version's
    hats."""
    from mnc_tpu_torch.ops.roi_warp import bin_centers, interp_matrix

    rois = torch.tensor([[[32.0, 16.0, 255.0, 239.0], [-16.0, 496.0, 207.0, 719.0]]])
    i0, w0, w1 = kernels.roi_warp_taps(rois, 14, SCALE, MAP[0], 0)
    assert bool((w1[0, 0] == 0).all()) and bool((w0[0, 0] == 1).all())
    assert i0[0, 0].tolist() == list(range(1, 15))  # y1 = 16 px: cell 1, a cell a bin
    i0, w0, w1 = kernels.roi_warp_taps(rois, 14, SCALE, MAP[1], 1)
    assert int(i0[0, 1, 0]) < 0 and float(w0[0, 1, 0]) == 0.0
    for axis, size in ((0, MAP[0]), (1, MAP[1])):
        i0, w0, w1 = kernels.roi_warp_taps(rois, 14, SCALE, size, axis)
        hats = interp_matrix(bin_centers(rois, 14, SCALE, axis), size)
        for k, wt in ((i0, w0), (i0 + 1, w1)):
            inside = (k >= 0) & (k < size)
            got = hats.gather(-1, k.clamp(0, size - 1)[..., None])[..., 0]
            assert torch.equal(torch.where(inside, got, 0.0), wt)


def test_l2_tap_bytes_from_the_boxes():
    """Per-RoI staging: used rows x used columns per RoI; the first port's:
    every tap, or each row block's distinct cells; this kernel: the map
    slab of every unit."""
    rois = torch.tensor([[[0.0, 0.0, 1023.0, 639.0], [100.0, 100.0, 100.0, 100.0],
                          [-500.0, -500.0, -300.0, -300.0], [32.0, 16.0, 255.0, 239.0]]])
    plan = kernels.plan_roi_warp(1, 4, 512, torch.bfloat16, (14, 14), MAP)
    got = kernels.roi_warp_l2_bytes(rois, (14, 14), SCALE, MAP, 512, 2, plan)
    line = 512 * 2
    # full canvas: 28 x 28 cells, every bin 4 taps; 1 px: 2 x 2 cells, 196 x 4 taps;
    # outside: nothing; integer centers (14 cells a side): 14 x 14 cells, one tap a bin
    assert got["per_roi"] == (28 * 28 + 2 * 2 + 0 + 14 * 14) * line
    assert got["old_every_tap"] == (196 * 4 + 196 * 4 + 0 + 196) * line
    assert got["old_per_row"] == (28 * 28 + 28 * 2 + 0 + 14 * 14) * line
    assert plan.units == 4 * 16  # four chunks of one RoI, 16 slabs
    assert got["staged"] == plan.units * 40 * 64 * 64
    assert "staged" not in kernels.roi_warp_l2_bytes(rois, (14, 14), SCALE, MAP, 512, 2)


def test_wrapper_hands_the_plan_to_the_c_interface(monkeypatch):
    """The wrapper's arguments match ``KERNEL_ABI['roi_warp']`` one for one
    (a count or a type that ctypes would convert wrongly shows here, not
    only on the card), and carry the plan's fields."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_on", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_stream", lambda t: 12345)
    feat = torch.zeros(2, *MAP, 512, dtype=torch.bfloat16)
    rois = torch.zeros(2, 128, 4)
    plan = kernels.plan_roi_warp(2, 128, 512, torch.bfloat16, (14, 14), MAP)
    out = kernels._roi_warp(fake, feat, rois, (14, 14), SCALE, plan)
    assert tuple(out.shape) == (2, 128, 14, 14, 512) and out.dtype == torch.bfloat16
    (args,) = calls
    argtypes = _build.KERNEL_ABI["roi_warp"][2]
    assert len(args) == len(argtypes)
    for arg, ty in zip(args, argtypes):
        assert isinstance(arg, float if ty is ctypes.c_float else int)
        ty(arg)  # ctypes takes it
    assert args[3:10] == (2, *MAP, 512, 128, 14, 14)
    assert args[11:17] == (1, plan.cell_chunks, plan.band_rows, plan.chunks, plan.grid,
                           plan.smem)
    assert args[17] == 12345
    # an empty output launches nothing
    calls.clear()
    assert kernels._roi_warp(fake, feat, rois[:, :0], (14, 14), SCALE, plan).numel() == 0
    assert not calls
