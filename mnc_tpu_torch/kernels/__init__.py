"""ctypes wrappers of the port's CUDA kernels, with launch counters.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
returns a CUDA error, and then adds one to its ``launches`` counter — a
plain integer attribute, so a run can show which kernels the main path
went through.  The ops modules register each kernel as a ``torch.library``
custom op (``mnc::roi_warp``, ``mnc::nms_keep``, ``mnc::paste_binarize``,
``mnc::block1``, ``mnc::gemm_s8``, ``mnc::quant_act``, ``mnc::act_scale``,
``mnc::quant_with_scale``) whose CUDA implementation calls the wrapper here
and whose CPU implementation is the plain PyTorch version; the gradients (A′, and D's
backward through its plain version) are called from ``autograd.Function``s.
Nothing here falls back.

    roi_warp_cuda        — kernel A, csrc/roi_warp.cu (replaces roi_warp_pallas)
    roi_warp_bwd_cuda    — kernel A', csrc/roi_warp_bwd.cu (replaces its VJP)
    nms_keep_cuda        — kernel B, csrc/nms.cu      (replaces nms_pallas)
    paste_binarize_cuda  — kernel C, csrc/paste.cu    (replaces paste_binarize_pallas)
    block1_cuda          — kernel D, csrc/block1.cu   (replaces fused_block1)
    gemm_s8_cuda         — kernel E, csrc/gemm_s8.cu  (the int8 conv / dense of
                           ops/quant.py; no Pallas counterpart)
    quant_act_cuda       — kernel F, csrc/quant_act.cu (the int8 activation
                           quantization; no Pallas counterpart)
    act_scale_cuda,      — kernel F's two halves, per tensor: the scale alone
    quant_with_scale_cuda  and the quantization under a given scale (a
                           tensor held in parts: the spatial trunk)

Kernel A's plan (``plan_roi_warp``) and taps (``roi_warp_taps``), kernel
A′'s tile lists and plan (``roi_warp_bwd_lists``, ``roi_warp_bwd_plan``,
plain twins of its first two launches), kernel E's planner
(``plan_gemm_s8``) and weight packing (``pack_gemm_s8_weight``) and kernel
F's plan (``plan_quant_act``) are plain Python and torch, tested on the
CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from mnc_tpu_torch.kernels._build import build, kernel_function  # noqa: F401


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, device=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _on(device: torch.device):
    """Makes ``device`` current for a launch (a no-op where it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch(name: str, device: torch.device, *args) -> None:
    with _on(device):
        err = kernel_function(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


ROI_WARP_THREADS = 1024  # csrc/roi_warp.cu kThreads
ROI_WARP_ROIS = 16  # kRoIs: RoIs whose tap tables a block builds at once
ROI_WARP_MAX_BLOCKS = 1  # kMinBlocks: blocks an SM its registers allow
ROI_WARP_CELL_CHUNKS = (8, 4, 2, 1)  # 16-byte chunks of a staged cell (its channel slab)
H100_SMEM_PER_SM = 233472  # shared memory of an SM; each block also holds 1 KB
H100_SMEM_PER_BLOCK = 232448  # the largest dynamic shared memory a block may opt into
SMEM_BLOCK_RESERVE = 1024


@dataclasses.dataclass(frozen=True)
class RoIWarpPlan:
    """How kernel A covers one call: ``units`` work units (image, chunk of
    ``chunk`` RoIs, slab of ``cell_chunks`` 16-byte chunks of channels), the
    slab fastest, each image's RoIs cut into ``chunks`` chunks; ``grid``
    persistent blocks of ``ROI_WARP_THREADS`` threads, block g taking units
    g, g + grid, ...  A unit stages its map slab in ``bands`` bands of
    ``band_rows`` rows (and one row of overlap), in ``smem`` bytes of
    dynamic shared memory, ``blocks_per_sm`` blocks an SM."""
    n: int
    h: int
    w: int
    cell_chunks: int
    slab: int  # channels of a slab
    slabs: int
    band_rows: int
    bands: int
    chunks: int
    chunk: int
    units: int
    grid: int
    smem: int
    blocks_per_sm: int

    def work(self):
        """(block, image, RoI, slab) of every (RoI, slab) item, in the
        kernel's order (``roi_warp_fwd_kernel``)."""
        for g in range(self.grid):
            for unit in range(g, self.units, self.grid):
                bc, slab = divmod(unit, self.slabs)
                img, h = divmod(bc, self.chunks)
                for roi in range(h * self.chunk, min(self.n, (h + 1) * self.chunk)):
                    yield g, img, roi, slab

    def staged_bytes(self) -> int:
        """The bytes of map cells the blocks copy from L2 into shared memory:
        the map slab of every unit, each band's rows and one of overlap."""
        rows = sum(min(self.band_rows + 1, self.h - y) for y in range(0, self.h, self.band_rows))
        return self.units * rows * self.w * self.cell_chunks * 16


def roi_warp_smem(cell_chunks: int, band_rows: int, map_hw, out_hw) -> int:
    """Kernel A's dynamic shared memory (csrc/roi_warp.cu ``smem_bytes``):
    the staged map band (``band_rows`` + 1 rows, at most H, of W cells) and
    the tap tables of ``ROI_WARP_ROIS`` RoIs."""
    (h, w), (ph, pw) = map_hw, out_hw
    return min(band_rows + 1, h) * w * cell_chunks * 16 + ROI_WARP_ROIS * (ph + pw) * 16


@functools.lru_cache(maxsize=1024)
def plan_roi_warp(b: int, n: int, c: int, dtype: torch.dtype, out_hw, map_hw, sms: int = 132,
                  smem_per_sm: int = H100_SMEM_PER_SM,
                  smem_per_block: int = H100_SMEM_PER_BLOCK,
                  cell_chunks: int = 8, band_rows: int | None = None) -> RoIWarpPlan:
    """Kernel A's plan for features (b, H, W, c) of ``dtype`` (f32 or
    bf16), b x n RoIs and ``out_hw`` bins on a card of ``sms`` SMs.

    A staged cell holds the widest of 8, 4, 2, 1 16-byte chunks (at most
    ``cell_chunks``) that divides c's vectors and with which a whole map
    slab fits a block's shared memory: 64 bytes (32 bf16 or 16 f32
    channels) for a 40 x 64 map at c = 512 or 1024.  A map too large even
    at 16 bytes a cell is staged in bands of as many rows as fit (one more
    row of overlap each); ``band_rows``, where given, sets the band and the
    widest cell that it fits.  As many blocks an SM as the shared memory and
    ``ROI_WARP_MAX_BLOCKS`` allow; each image's RoIs cut into as many equal
    chunks as leave every one of those blocks an (image, chunk, slab) unit
    (the slabs of a chunk then run side by side, so the 16-byte pieces of
    an output bin reach L2 together), at most that many blocks."""
    ph, pw = out_hw
    h, w = map_hw
    vec = 16 // dtype.itemsize
    if c % vec:
        raise ValueError(f"channels ({c}) must be a multiple of {vec}")
    if min(ph, pw, h, w) < 1:
        raise ValueError(f"{out_hw} bins on a {map_hw} map")
    widths = [k for k in ROI_WARP_CELL_CHUNKS if k <= cell_chunks and (c // vec) % k == 0]
    fits = [k for k in widths if roi_warp_smem(k, h, map_hw, out_hw) <= smem_per_block]
    if band_rows is not None:  # given: the widest cell whose band of that many rows fits
        cpc = next((k for k in widths
                    if roi_warp_smem(k, band_rows, map_hw, out_hw) <= smem_per_block), 0)
        if not cpc or not 1 <= band_rows <= h:
            raise ValueError(f"no band of {band_rows} rows of a {map_hw} map fits")
    elif fits:
        cpc, band_rows = fits[0], h
    else:  # bands of one-chunk cells
        cpc = widths[-1]
        band_rows = (smem_per_block - roi_warp_smem(cpc, 0, (0, w), out_hw)) // (w * cpc * 16) - 1
        if band_rows < 1:
            raise ValueError(f"kernel A cannot stage two rows of a {map_hw} map in "
                             f"{smem_per_block} bytes of shared memory")
    smem = roi_warp_smem(cpc, band_rows, map_hw, out_hw)
    slabs = c // (vec * cpc)
    if h * w * c >= 2 ** 31 or b * n * ph * pw >= 2 ** 31:
        raise ValueError("kernel A takes maps and outputs of fewer than 2^31 elements")
    per_sm = max(1, min(ROI_WARP_MAX_BLOCKS, smem_per_sm // (smem + SMEM_BLOCK_RESERVE)))
    # each image's RoIs in as many chunks as leave every SM a unit, none empty
    chunks = max(1, min(n, per_sm * sms // max(1, b * slabs)))
    chunk = max(1, -(-n // chunks))
    chunks = max(1, -(-n // chunk))
    units = b * chunks * slabs
    return RoIWarpPlan(n=n, h=h, w=w, cell_chunks=cpc, slab=vec * cpc, slabs=slabs,
                       band_rows=band_rows, bands=-(-h // band_rows), chunks=chunks,
                       chunk=chunk, units=units, grid=max(1, min(units, per_sm * sms)),
                       smem=smem, blocks_per_sm=per_sm)


def roi_warp_taps(rois: torch.Tensor, out_size: int, spatial_scale: float, size: int,
                  axis: int):
    """Kernel A's taps along one axis (``taps(bin_center(...))``): for
    (..., N, 4) rois, (i0, w0, w1) of shape (..., N, P): the floor of each
    bin center and the hat weights of taps i0 and i0 + 1, 0 outside
    [0, size).  The f32 arithmetic is the kernel's, operation by
    operation."""
    from mnc_tpu_torch.ops.roi_warp import bin_centers

    cen = bin_centers(rois, out_size, spatial_scale, axis)
    f = torch.floor(cen)
    i0 = f.to(torch.int64)
    zero = cen.new_zeros(())
    a = torch.maximum(zero, 1.0 - (cen - f).abs())
    b = torch.maximum(zero, 1.0 - (cen - (f + 1.0)).abs())
    w0 = torch.where((i0 >= 0) & (i0 < size), a, zero)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < size), b, zero)
    return i0, w0, w1


def _used_lines(i0: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, size: int):
    """(..., size) bool: the lines (rows or columns) that a tap of nonzero
    weight falls on."""
    used = torch.zeros((*i0.shape[:-1], size + 1), dtype=torch.bool, device=i0.device)
    for idx, wt in ((i0, w0), (i0 + 1, w1)):
        on = wt != 0
        used.scatter_(-1, torch.where(on, idx, size).clamp(0, size), on)  # line size: a sink
    return used[..., :size]


def roi_warp_l2_bytes(rois: torch.Tensor, out_hw, spatial_scale: float, map_hw, c: int,
                      itemsize: int, plan: RoIWarpPlan | None = None) -> dict:
    """The bytes of feature taps that kernel A designs read through L2 for
    these (B, N, 4) rois, computed from the boxes and shapes: ``staged``,
    this kernel's map slabs (``plan.staged_bytes``, when a plan is given);
    ``per_roi``, each RoI's used rows x used columns, once (a design that
    stages per RoI); for the first port's design (a block per RoI and
    output row, four 16-byte loads per output vector), ``old_every_tap``
    (every tap of nonzero weight, each bin on its own) and ``old_per_row``
    (each block's distinct cells once, were L1 to catch every re-read
    inside a block)."""
    ph, pw = out_hw
    h, w = map_hw
    yi, wy0, wy1 = roi_warp_taps(rois, ph, spatial_scale, h, 0)
    xi, wx0, wx1 = roi_warp_taps(rois, pw, spatial_scale, w, 1)
    rows = _used_lines(yi, wy0, wy1, h).sum(-1)
    cols = _used_lines(xi, wx0, wx1, w).sum(-1)
    row_taps = ((wy0 != 0).to(torch.int64) + (wy1 != 0).to(torch.int64)).sum(-1)  # (B, N)
    col_taps = ((wx0 != 0).to(torch.int64) + (wx1 != 0).to(torch.int64)).sum(-1)
    line = c * itemsize
    out = {"per_roi": int((rows * cols).sum()) * line,
           "old_every_tap": int((row_taps * col_taps).sum()) * line,
           "old_per_row": int((row_taps * cols).sum()) * line}
    if plan is not None:
        out["staged"] = plan.staged_bytes()
    return out


def _roi_warp(fn, features: torch.Tensor, rois: torch.Tensor, out_hw, spatial_scale: float,
              plan: RoIWarpPlan | None = None) -> torch.Tensor:
    """Checks, plans and launches kernel A through the C function ``fn`` (or
    the kernel of that name); ``plan`` overrides :func:`plan_roi_warp`'s."""
    _check(features, "features", (torch.float32, torch.bfloat16), 4)
    _check(rois, "rois", (torch.float32,), 3, features.device)
    b, h, w, c = features.shape
    if rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois shape {tuple(rois.shape)} does not match "
                         f"features {tuple(features.shape)}")
    vec = 16 // features.element_size()
    if c % vec:
        raise ValueError(f"channels ({c}) must be a multiple of {vec}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"a feature map of {(h, w, c)} has 2^31 elements or more")
    ph, pw = out_hw
    n = rois.shape[1]
    dev = features.device
    out = torch.empty((b, n, ph, pw, c), dtype=features.dtype, device=dev)
    if out.numel() == 0:
        return out
    if features.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("features and the output must be 16-byte aligned")
    if plan is None:
        plan = plan_roi_warp(b, n, c, features.dtype, (ph, pw), (h, w), _n_sms(dev),
                             _smem_per_sm(dev), _smem_per_block(dev))
    if isinstance(fn, str):
        fn = kernel_function(fn)
    with _on(dev):
        err = fn(features.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, n, ph, pw,
                 float(spatial_scale), 0 if features.dtype == torch.float32 else 1,
                 plan.cell_chunks, plan.band_rows, plan.chunks, plan.grid, plan.smem,
                 _stream(features))
    if err != 0:
        raise RuntimeError(f"CUDA kernel 'roi_warp' failed to launch: CUDA error {err} ({plan})")
    return out


def roi_warp_cuda(features: torch.Tensor, rois: torch.Tensor, out_hw,
                  spatial_scale: float) -> torch.Tensor:
    """features (B, H, W, C) f32/bf16, rois (B, N, 4) f32 → (B, N, PH, PW, C).
    One launch of a persistent grid planned by :func:`plan_roi_warp`; an
    empty output launches nothing and is not counted."""
    out = _roi_warp("roi_warp", features, rois, out_hw, spatial_scale)
    if out.numel():
        roi_warp_cuda.launches += 1
    return out


ROI_WARP_BWD_TILE = (4, 4)  # csrc/roi_warp_bwd.cu MNC_RWB_TILE_H, MNC_RWB_TILE_W
ROI_WARP_BWD_EXTRA_UNITS = 512  # MNC_RWB_EXTRA_UNITS: E, the splits beyond one a tile
ROI_WARP_BWD_MAX_SPLITS = 32  # MNC_RWB_MAX_SPLITS


def roi_warp_bwd_tiles(map_hw) -> tuple[int, int]:
    """Kernel A′'s dF tiles of a (H, W) map: (tiles down, tiles across),
    tile t = row * across + column."""
    (h, w), (th, tw) = map_hw, ROI_WARP_BWD_TILE
    return -(-h // th), -(-w // tw)


def roi_warp_bwd_lists(rois: torch.Tensor, out_hw, spatial_scale: float, map_hw):
    """Plain twin of kernel A′'s tile lists (its first launch): for (B, N, 4)
    rois, (counts (B, T) int64, lists (B, T, N) int64): the RoIs whose taps
    can touch tile t, in ascending index, then -1.

    A RoI can touch the rows floor(c) - 1 .. floor(c) + 1 around the first
    and the last bin center c along y (the centers are monotone in the
    bin), clipped to the map, the centers clamped to [-2, H + 1] first (the
    clipped range is the same); likewise along x.  A NaN center touches
    nothing.  The f32 arithmetic is the kernel's."""
    from mnc_tpu_torch.ops.roi_warp import bin_centers

    (ph, pw), (h, w) = out_hw, map_hw
    (th, tw), (nth, ntw) = ROI_WARP_BWD_TILE, roi_warp_bwd_tiles(map_hw)

    def reaches(axis, bins, size, tile, n_tiles):  # (B, N, n_tiles) bool
        cen = bin_centers(rois, bins, spatial_scale, axis)
        e0, e1 = cen[..., 0], cen[..., -1]
        first = torch.floor(torch.minimum(e0, e1).clamp(-2.0, size + 1.0)).long() - 1
        last = torch.floor(torch.maximum(e0, e1).clamp(-2.0, size + 1.0)).long() + 1
        a = torch.arange(n_tiles, device=rois.device) * tile
        b = torch.clamp(a + tile, max=size) - 1
        ok = ~(e0.isnan() | e1.isnan())
        return (first[..., None] <= b) & (last[..., None] >= a) & ok[..., None]

    ry, rx = reaches(0, ph, h, th, nth), reaches(1, pw, w, tw, ntw)
    touch = (ry[:, :, :, None] & rx[:, :, None, :]).flatten(2).transpose(1, 2)  # (B, T, N)
    n = rois.shape[1]
    idx = torch.arange(n, device=rois.device).expand_as(touch)
    lists = torch.sort(torch.where(touch, idx, n), dim=-1).values
    return touch.sum(-1), torch.where(lists < n, lists, -1)


def roi_warp_bwd_plan(counts: torch.Tensor):
    """Plain twin of kernel A′'s plan (its second launch): for the lists'
    counts (any shape, tiles in order), (splits, unit bases), both flat
    int64 over the tiles: a tile of ``count`` RoIs gets floor(count · E /
    total) splits, at least 1, at most ``ROI_WARP_BWD_MAX_SPLITS`` and
    ``count``; split s of a tile walks its list's entries
    [s · count // splits, (s + 1) · count // splits), and its units are
    numbered from its unit base on, tile after tile."""
    c = counts.flatten().long()
    total = max(int(c.sum()), 1)
    splits = torch.minimum(c * ROI_WARP_BWD_EXTRA_UNITS // total,
                           c.clamp(max=ROI_WARP_BWD_MAX_SPLITS)).clamp(min=1)
    return splits, torch.cumsum(splits, 0) - splits


def roi_warp_bwd_scratch(b: int, n: int, map_hw, c: int, out_hw) -> tuple[int, int]:
    """Kernel A′'s scratch for b maps of ``map_hw`` and c channels, n RoIs
    an image of ``out_hw`` bins: (int32 elements: lists, counts, splits,
    unit bases, the unit count, units; f32 elements: the splits' partial
    sums, then the bin centers)."""
    nth, ntw = roi_warp_bwd_tiles(map_hw)
    bt = b * nth * ntw
    units = bt + ROI_WARP_BWD_EXTRA_UNITS
    th, tw = ROI_WARP_BWD_TILE
    return bt * n + 3 * bt + 1 + units, units * th * tw * c + b * n * sum(out_hw)


def roi_warp_bwd_read_lists(ints: torch.Tensor, b: int, n: int, map_hw):
    """Kernel A′'s lists and plan from its int32 scratch (``_roi_warp_bwd``
    with ``keep_scratch``): (counts (B, T), lists (B, T, N) with -1 past
    each count, splits (B T,), unit bases (B T,)), as the plain twins give
    them."""
    nth, ntw = roi_warp_bwd_tiles(map_hw)
    t = nth * ntw
    bt = b * t
    ints = ints.long()
    lists = ints[:bt * n].view(b, t, n)
    counts = ints[bt * n:bt * n + bt].view(b, t)
    splits = ints[bt * n + bt:bt * n + 2 * bt]
    unit_base = ints[bt * n + 2 * bt:bt * n + 3 * bt]
    pos = torch.arange(n, device=ints.device)
    return counts, torch.where(pos < counts[..., None], lists, -1), splits, unit_base


def _roi_warp_bwd(grad_out: torch.Tensor, features: torch.Tensor, rois: torch.Tensor,
                  spatial_scale: float, keep_scratch: bool = False):
    """Checks and launches kernel A′; (d features, d rois), and its int32
    scratch (the lists and the plan) where ``keep_scratch``."""
    _check(features, "features", (torch.float32, torch.bfloat16), 4)
    _check(grad_out, "grad_out", (features.dtype,), 5, features.device)
    _check(rois, "rois", (torch.float32,), 3, features.device)
    b, h, w, c = features.shape
    n = rois.shape[1]
    ph, pw = grad_out.shape[2:4]
    if tuple(rois.shape) != (b, n, 4) or tuple(grad_out.shape) != (b, n, ph, pw, c):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} / rois {tuple(rois.shape)} do "
                         f"not match features {tuple(features.shape)}")
    vec = 4 if features.dtype == torch.float32 else 8
    if c % vec:
        raise ValueError(f"channels ({c}) must be a multiple of {vec}")
    if ph + pw > 512 or n > 65535 or b > 65535:
        raise ValueError(f"output size {(ph, pw)}, {b} x {n} RoIs: at most 512 rows + "
                         f"columns and 65535 images and RoIs an image")
    dev = features.device
    if b * n == 0:  # nothing reaches the maps; no launch
        out = (torch.zeros_like(features), torch.zeros((b, n, 4), device=dev))
        return (*out, None) if keep_scratch else out
    n_ints, n_partial = roi_warp_bwd_scratch(b, n, (h, w), c, (ph, pw))
    dfeat = torch.empty((b, h, w, c), dtype=features.dtype, device=dev)
    drois = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dev)
    partial = torch.empty(n_partial, dtype=torch.float32, device=dev)
    _launch("roi_warp_bwd", dev, grad_out.data_ptr(), features.data_ptr(), rois.data_ptr(),
            dfeat.data_ptr(), drois.data_ptr(), ints.data_ptr(), partial.data_ptr(), b, h, w,
            c, n, ph, pw, float(spatial_scale), 0 if features.dtype == torch.float32 else 1,
            _stream(features))
    return (dfeat, drois, ints) if keep_scratch else (dfeat, drois)


def roi_warp_bwd_cuda(grad_out: torch.Tensor, features: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float):
    """Gradients of :func:`roi_warp_cuda`: grad_out (B, N, PH, PW, C) and
    features (B, H, W, C), both f32 or both bf16, rois (B, N, 4) f32 →
    (d features (B, H, W, C) in the feature dtype, d rois (B, N, 4) f32).

    Both are summed in an order that the inputs alone fix, so two calls on
    the same inputs agree bit for bit: d rois by a fixed-order reduction in
    one block a RoI; d features by map tile, over the RoIs that
    :func:`roi_warp_bwd_lists` lists for the tile in ascending index (cut
    into the splits of :func:`roi_warp_bwd_plan`, added in split order), in
    f32, rounded to the feature dtype once.  Four CUDA launches (lists and d
    rois, plan, dF, the splits' sum), counted once."""
    out = _roi_warp_bwd(grad_out, features, rois, spatial_scale)
    if rois.shape[0] * rois.shape[1]:
        roi_warp_bwd_cuda.launches += 1
    return out


def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                  top_n: int = 0) -> torch.Tensor:
    """Greedy NMS keep masks: boxes (P, K, 4) f32 score-sorted, valid (P, K)
    bool → keep (P, K) bool.  ``top_n`` > 0 stops each scan after that many
    keeps.  One launch, no scratch: the scan keeps its state in shared memory."""
    _check(boxes, "boxes", (torch.float32,), 3)
    _check(valid, "valid", (torch.bool,), 2, boxes.device)
    p, k, four = boxes.shape
    if four != 4 or tuple(valid.shape) != (p, k):
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
    _launch("nms", boxes.device, boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            p, k, float(thresh), int(top_n), _stream(boxes))
    nms_keep_cuda.launches += 1
    return keep


def paste_binarize_cuda(wy: torch.Tensor, masks: torch.Tensor, wxt: torch.Tensor,
                        thresh: float) -> torch.Tensor:
    """(N, H, M) hats × (N, M, M) masks × (N, M, W) hatsᵀ → bool (N, H, W).
    Two launches on the current stream: the in-box column and row ranges of
    each detection's hats into an (N, 4) int32 scratch, then the canvas
    bands."""
    _check(wy, "wy", (torch.float32,), 3)
    _check(masks, "masks", (torch.float32,), 3, wy.device)
    _check(wxt, "wxt", (torch.float32,), 3, wy.device)
    n, h, m = wy.shape
    w = wxt.shape[2]
    if tuple(masks.shape) != (n, m, m) or tuple(wxt.shape[:2]) != (n, m):
        raise ValueError(f"wy {tuple(wy.shape)} / masks {tuple(masks.shape)} / "
                         f"wxt {tuple(wxt.shape)}")
    out = torch.empty((n, h, w), dtype=torch.bool, device=wy.device)
    ext = torch.empty((n, 4), dtype=torch.int32, device=wy.device)
    if out.data_ptr() % 16:
        raise ValueError("the output canvas must be 16-byte aligned")
    _launch("paste_binarize", wy.device, wy.data_ptr(), masks.data_ptr(),
            wxt.data_ptr(), ext.data_ptr(), out.data_ptr(), n, h, w, m, float(thresh),
            _stream(wy))
    paste_binarize_cuda.launches += 1
    return out


def block1_cuda(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor, w2p: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """Fused VGG block 1, all bf16: x (B, H, W, 3) with H, W even → (B, H/2,
    W/2, 64).  The weights come packed by
    ``ops.block1.pack_block1_weights``: w1p (64, 32), w2p (9, 64, 64); b1
    and b2 (64,)."""
    bf = (torch.bfloat16,)
    _check(x, "x", bf, 4)
    b, h, w, c = x.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"x has shape {tuple(x.shape)}: 3 channels and even H, W needed")
    for t, name, shape in ((w1p, "w1p", (64, 32)), (b1, "b1", (64,)),
                           (w2p, "w2p", (9, 64, 64)), (b2, "b2", (64,))):
        _check(t, name, bf, len(shape), x.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if any(t.data_ptr() % 16 for t in (x, w1p, b1, w2p, b2)):
        raise ValueError("x, w1p, b1, w2p and b2 must be 16-byte aligned")
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16, device=x.device)
    _launch("block1", x.device, x.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
            b2.data_ptr(), out.data_ptr(), b, h, w, _stream(x))
    block1_cuda.launches += 1
    return out


# Kernel E's geometry (csrc/gemm_s8.cu): 128-row output tiles, 128-byte
# k-blocks, A loaded by one of four modes, split-K where tiles are few.
GEMM_S8_BM = 128
GEMM_S8_BK = 128
GEMM_S8_MODES = ("tma", "im2col", "staged", "gather")
GEMM_S8_MAX_SPLITS = 16
GEMM_S8_SPLIT_COST = 8  # a slice's plane store and reduction, in k-blocks of work
GEMM_S8_WIDE_COST = 1.6  # a 256-wide tile's k-block against a 128-wide one's (2x the
#                          products for 1.5x the operand bytes)
GEMM_S8_HALO_BUF = 6144  # bytes of one STAGED halo buffer (raw or padded)
GEMM_S8_MAX_STAGED_K = 1024


def gemm_s8_n_pad(n: int) -> int:
    """The multiple that kernel E's packed weights pad ``n`` rows to: its
    narrowest N tile for n, 64 where Cout <= 64, else 128 (a 256-wide tile
    is taken only where 256 divides n)."""
    return 64 if n <= 64 else 128


def gemm_s8_halo_bytes(stride: int, kw: int) -> tuple[int, int]:
    """(raw, padded) bytes per input row of a STAGED halo (C = 3): a tile's
    128 output pixels need (127 * stride + KW) pixels; the raw row keeps up
    to 15 bytes of alignment in front and is rounded up to 16."""
    padded = ((GEMM_S8_BM - 1) * stride + kw) * 3
    return (15 + padded + 15) // 16 * 16, padded


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How kernel E covers one GEMM: ``mode`` loads A, ``bn``-wide N tiles
    of 128 rows (``m_tiles`` x ``n_tiles``), ``k_blocks`` 128-byte
    k-blocks cut into ``splits`` slices of ``kb_per_split``, ``grid``
    persistent blocks; ``m_fast`` walks the M tiles of an N tile in turn."""
    mode: str
    bn: int
    m: int
    n: int
    k: int
    m_tiles: int
    n_tiles: int
    k_blocks: int
    splits: int
    kb_per_split: int
    m_fast: bool
    grid: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    def units(self):
        """(m0, n0, kb0, kb1) of every work unit, in the kernel's order
        (``unit_of`` in csrc/gemm_s8.cu): slices outermost."""
        for u in range(self.tiles * self.splits):
            split, tile = divmod(u, self.tiles)
            if self.m_fast:
                nt, mt = divmod(tile, self.m_tiles)
            else:
                mt, nt = divmod(tile, self.n_tiles)
            kb0 = split * self.kb_per_split
            yield (mt * GEMM_S8_BM, nt * self.bn, kb0,
                   min(kb0 + self.kb_per_split, self.k_blocks))

    def k_steps(self, kb: int) -> int:
        """The k32 steps of k-block ``kb`` that hold some k < K: the bytes of
        A that the STAGED and GATHER loaders write (the wgmmas read the whole
        block; past K the packed weights are zero)."""
        return min(4, (self.k - kb * GEMM_S8_BK + 31) // 32)


def _gemm_s8_waves(tiles: int, kb: int, splits: int, n_sms: int):
    per = -(-kb // splits)
    used = -(-kb // per)  # slices that hold a k-block
    cost = -(-tiles * used // n_sms) * (per + (GEMM_S8_SPLIT_COST if used > 1 else 0))
    return cost, used, per


@functools.lru_cache(maxsize=1024)
def plan_gemm_s8(m: int, n: int, k: int, *, c: int, kh: int, kw: int, stride: int, pad: int,
                 ow: int, conv: bool, aligned: bool, out_bf16: bool = True,
                 n_sms: int = 132) -> GemmPlan:
    """Kernel E's plan for an (m, k) x (k, n) product: a convolution's
    implicit im2col (``conv``; c input channels, kernel kh x kw, ``stride``,
    ``pad``, output width ``ow``) or a dense (m, k) matrix.  ``aligned``:
    the activations start on a 16-byte boundary.

    A's loader: TMA where A is a plain (M, K) matrix (dense, or a 1x1
    stride-1 convolution) with K % 16 == 0; 16-byte im2col where C % 16 ==
    0; the staged halo where C == 3, Cout <= 64, K <= 1024 and every tile lies
    in one output row; byte gathers otherwise.  The N tile is 64 where
    Cout <= 64; else 128, or 256 for a bf16 output whose N is a multiple of
    256 where A is loaded by im2col.  The tile width and the slice count of
    split-K (at most 16) are
    those with the fewest k-blocks per SM over their waves, each slice
    charged ``GEMM_S8_SPLIT_COST`` k-blocks for its reduction and a 256-wide
    k-block ``GEMM_S8_WIDE_COST`` 128-wide ones."""
    plain = not conv or (kh == kw == 1 and stride == 1 and pad == 0)
    if plain and k % 16 == 0 and aligned:
        mode = "tma"
    elif conv and not plain and c % 16 == 0 and aligned:
        mode = "im2col"
    elif (conv and c == 3 and n <= 64 and k <= GEMM_S8_MAX_STAGED_K and ow % GEMM_S8_BM == 0
          and aligned and kh * max(gemm_s8_halo_bytes(stride, kw)) <= GEMM_S8_HALO_BUF):
        mode = "staged"
    else:
        mode = "gather"
    kb = -(-k // GEMM_S8_BK)
    m_tiles = -(-m // GEMM_S8_BM)
    widths = [gemm_s8_n_pad(n)]
    if mode == "im2col" and out_bf16 and n % 256 == 0:  # TMA-fed products ran slower at 256
        widths.append(256)
    best = None
    for bn in widths:
        tiles = m_tiles * -(-n // bn)
        for s in range(1, min(kb, GEMM_S8_MAX_SPLITS) + 1):
            cost, used, per = _gemm_s8_waves(tiles, kb, s, n_sms)
            cost *= GEMM_S8_WIDE_COST if bn == 256 else 1.0
            if best is None or cost < best[0]:
                best = (cost, bn, used, per)
    _, bn, splits, per = best
    n_tiles = -(-n // bn)
    return GemmPlan(mode=mode, bn=bn, m=m, n=n, k=k, m_tiles=m_tiles, n_tiles=n_tiles,
                    k_blocks=kb, splits=splits, kb_per_split=per, m_fast=not conv,
                    grid=min(m_tiles * n_tiles * splits, n_sms))


def pack_gemm_s8_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 weights (N, KH, KW, C) or (N, K) -> kernel E's B operand
    (ceil(K / 128), N rounded up by :func:`gemm_s8_n_pad`, 128): 128-byte k-blocks of
    each row, zero-padded in K and N, with the 16-byte chunk c of row n
    stored at c ^ (n % 8) -- the 128-byte swizzle that a wgmma descriptor
    reads, so one stage of B is one contiguous copy."""
    n = wq.shape[0]
    w2 = wq.reshape(n, -1)
    k = w2.shape[1]
    kb = -(-k // GEMM_S8_BK)
    n_pad = -(-n // gemm_s8_n_pad(n)) * gemm_s8_n_pad(n)
    buf = torch.zeros((n_pad, kb * GEMM_S8_BK), dtype=torch.int8, device=wq.device)
    buf[:n, :k] = w2
    return _swizzle(buf.view(n_pad, kb, 8, 16).permute(1, 0, 2, 3)).reshape(kb, n_pad, 128)


def unpack_gemm_s8_weight(wp: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`pack_gemm_s8_weight`: wp back to ``shape``."""
    kb, n_pad, _ = wp.shape
    rows = _swizzle(wp.view(kb, n_pad, 8, 16)).permute(1, 0, 2, 3).reshape(n_pad, -1)
    n, k = shape[0], int(torch.Size(shape[1:]).numel())
    return rows[:n, :k].reshape(shape).contiguous()


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """(kb, n, 8, 16) -> chunk p of row n from chunk p ^ (n % 8) (an involution)."""
    n = t.shape[1]
    idx = torch.arange(8, device=t.device)[None, :] ^ (torch.arange(n, device=t.device)[:, None]
                                                        % 8)
    return torch.gather(t, 2, idx[None, :, :, None].expand(t.shape).contiguous())


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gemm_s8(fn, xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
             bias: torch.Tensor | None, stride: int, padding: int, out_dtype: torch.dtype,
             wp: torch.Tensor | None) -> torch.Tensor:
    """Checks, plans and launches kernel E through the C function ``fn`` (or
    the kernel of that name, loaded once the operands have passed)."""
    conv = xq.dim() == 4
    _check(xq, "xq", (torch.int8,), 4 if conv else 2)
    dev = xq.device
    _check(wq, "wq", (torch.int8,), 4 if conv else 2, dev)
    _check(ws, "ws", (torch.float32,), 1, dev)
    if not isinstance(xs, torch.Tensor) or xs.device != dev or xs.dtype != torch.float32:
        raise ValueError("xs must be an f32 tensor on the device of xq")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    n = wq.shape[0]
    if ws.shape[0] != n:
        raise ValueError(f"ws has shape {tuple(ws.shape)}, wq {tuple(wq.shape)}")
    if bias is not None:
        _check(bias, "bias", (torch.float32,), 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has shape {tuple(bias.shape)}, wq {tuple(wq.shape)}")
    if conv:
        b, h, w, c = xq.shape
        kh, kw = wq.shape[1:3]
        if wq.shape[3] != c or kh != kw:
            raise ValueError(f"wq {tuple(wq.shape)} does not match xq {tuple(xq.shape)}")
        if xs.numel() != 1:
            raise ValueError(f"a convolution takes one activation scale, got {xs.numel()}")
        oh, ow = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
        if stride < 1 or padding < 0 or oh < 1 or ow < 1:
            raise ValueError(f"stride {stride} / padding {padding} for {(h, w)} x {(kh, kw)}")
        out = torch.empty((b, oh, ow, n), dtype=out_dtype, device=dev)
        m, k = b * oh * ow, kh * kw * c
    else:
        m, c = xq.shape
        if wq.shape[1] != c:
            raise ValueError(f"wq {tuple(wq.shape)} does not match xq {tuple(xq.shape)}")
        if tuple(xs.shape) != (m, 1) or not xs.is_contiguous():
            raise ValueError(f"xs has shape {tuple(xs.shape)}, expected ({m}, 1) contiguous")
        b, h, w, kh, kw, oh, ow = m, 1, 1, 1, 1, 1, 1
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        k, stride, padding = c, 1, 0
    plan = plan_gemm_s8(m, n, k, c=c, kh=kh, kw=kw, stride=stride, pad=padding, ow=ow,
                        conv=conv, aligned=xq.data_ptr() % 16 == 0,
                        out_bf16=out_dtype == torch.bfloat16, n_sms=_n_sms(dev))
    if wp is None:
        wp = pack_gemm_s8_weight(wq)
    _check(wp, "wp", (torch.int8,), 3, dev)
    if tuple(wp.shape) != (plan.k_blocks, plan.n_tiles * plan.bn, 128) or wp.data_ptr() % 16:
        raise ValueError(f"wp has shape {tuple(wp.shape)}: not the packing of wq "
                         f"{tuple(wq.shape)} (pack_gemm_s8_weight), or is unaligned")
    if isinstance(fn, str):
        fn = kernel_function(fn)
    scratch = None
    if plan.splits > 1:  # a plane of int32 partial sums per slice
        scratch = torch.empty(plan.splits * m * n, dtype=torch.int32, device=dev)
    with _on(dev):
        err = fn(xq.data_ptr(), wp.data_ptr(), xs.data_ptr(), int(not conv), ws.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, h, w, c, n, kh, kw,
                 stride, padding, oh, ow, int(out_dtype == torch.bfloat16), int(plan.m_fast),
                 GEMM_S8_MODES.index(plan.mode), plan.bn, plan.splits, plan.kb_per_split,
                 plan.grid, _stream(xq))
    if err != 0:
        raise RuntimeError(f"CUDA kernel 'gemm_s8' failed to launch: CUDA error {err}")
    return out


def gemm_s8_cuda(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                 bias: torch.Tensor | None, stride: int = 1, padding: int = 0,
                 out_dtype: torch.dtype = torch.bfloat16,
                 wp: torch.Tensor | None = None) -> torch.Tensor:
    """s8 × s8 → s32 on the tensor cores (wgmma), dequantized to
    ``out_dtype`` (f32 or bf16) as ``acc * (xs * ws) + bias``.  A
    convolution: xq (B, H, W, C) int8, wq (Cout, KH, KW, C) int8 (KH = KW),
    ``stride`` and symmetric ``padding``, xs one f32 scale → (B, OH, OW,
    Cout).  A dense layer: xq (M, K) int8, wq (N, K) int8, xs (M, 1) f32 →
    (M, N).  ws (N,) f32, bias (N,) f32 or None.  ``wp`` is wq packed by
    :func:`pack_gemm_s8_weight` (packed here when None; the int8 layers keep
    it cached per weight version).  :func:`plan_gemm_s8` picks the tiles, A's
    loader and split-K; a split-K plan takes an int32 scratch, a plane per
    slice, and a second launch adds the planes and dequantizes."""
    out = _gemm_s8("gemm_s8", xq, wq, xs, ws, bias, stride, padding, out_dtype, wp)
    gemm_s8_cuda.launches += 1
    return out


QUANT_ACT_TENSOR_THREADS = 1024  # csrc/quant_act.cu kTensorThreads: one block an SM
QUANT_ACT_ROW_THREADS = 512  # kRowThreads: up to two blocks an SM
QUANT_ACT_MAX_BLOCKS = 1024  # kMaxBlocks: partial maxima of a per-tensor grid
QUANT_ACT_SCRATCH_WORDS = 64 + QUANT_ACT_MAX_BLOCKS  # kSyncWords + kMaxBlocks
QUANT_ACT_SMEM_RESERVE = 1024  # bytes a block keeps beside what it holds (static shared memory)
QUANT_ACT_MIN_UNITS = 2  # per tensor: at least this many 16-byte units a thread


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """How kernel F covers one call: ``grid`` blocks of ``threads``, each
    with ``smem`` bytes of dynamic shared memory; units of ``unit`` elements
    (16 bytes where ``vec``, else one element).  Per tensor: a block takes
    ``chunk`` units and holds the last ``held`` of them on chip across the
    grid barrier.  Per row: ``rows_per_block`` rows at a time, each of
    ``chunk`` units taken by ``threads_per_row`` threads, the last ``held``
    of them held on chip.
    ``on_chip``: the input is read from HBM once."""
    per_row: bool
    vec: bool
    unit: int
    on_chip: bool
    grid: int
    threads: int
    smem: int
    chunk: int
    held: int
    rows_per_block: int
    threads_per_row: int

    def bytes_read_twice(self, n: int, itemsize: int) -> int:
        """The input bytes a call reads a second time (from L2 or HBM)."""
        if self.on_chip:
            return 0
        if self.per_row:
            return n // (self.chunk * self.unit) * (self.chunk - self.held) * self.unit * itemsize
        units = n // self.unit
        held = sum(min(self.held, max(0, min(self.chunk, units - b * self.chunk)))
                   for b in range(self.grid))
        return (n - held * self.unit) * itemsize


@functools.lru_cache(maxsize=1024)
def plan_quant_act(shape, per_row: bool, dtype: torch.dtype = torch.bfloat16, sms: int = 132,
                   smem: int = H100_SMEM_PER_BLOCK, aligned: bool = True) -> QuantPlan:
    """Kernel F's plan for an input of ``shape`` and ``dtype`` (bf16 or f32)
    on a card of ``sms`` SMs whose blocks may opt into ``smem`` bytes of
    dynamic shared memory (an SM holds ``smem`` + 1 KB).  ``aligned``: the
    input starts on a 16-byte boundary (16-byte units; per row also rows of
    whole units), else one element a unit.

    Per tensor: one cooperative block of 1024 threads an SM at most (the
    grid is co-resident), at least two units a thread; the blocks split the
    units evenly, and each holds as much of its share as its shared memory
    takes: the whole share (``on_chip``) or its tail, the rest read again.
    Per row: blocks of 512 threads, a row to 32-512 of them (about eight
    units a thread), as many rows a block as its shared memory holds, fewer
    where that leaves SMs idle (while a row's threads have a unit each); of
    a row longer than a block's shared memory the tail is held and the rest
    read again."""
    itemsize = dtype.itemsize
    n = int(torch.Size(shape).numel())
    if n < 1 or len(shape) < 1:
        raise ValueError(f"shape {tuple(shape)}: nothing to quantize")
    cap = (smem - QUANT_ACT_SMEM_RESERVE) // 16 * 16
    if not per_row:
        unit = 16 // itemsize if aligned else 1
        unit_bytes = unit * itemsize
        units = n // unit
        threads = QUANT_ACT_TENSOR_THREADS
        grid = max(1, min(sms, QUANT_ACT_MAX_BLOCKS,
                          -(-units // (threads * QUANT_ACT_MIN_UNITS))))
        chunk = max(1, -(-units // grid))
        grid = max(1, -(-units // chunk))  # no block without units
        held = min(chunk, cap // unit_bytes)
        return QuantPlan(per_row=False, vec=aligned, unit=unit, on_chip=held == chunk,
                         grid=grid, threads=threads, smem=held * unit_bytes, chunk=chunk,
                         held=held, rows_per_block=1, threads_per_row=threads)
    k = int(shape[-1])
    rows = n // k
    vec = aligned and k * itemsize % 16 == 0
    unit = 16 // itemsize if vec else 1
    row_bytes = k * itemsize
    ku = k // unit
    threads = QUANT_ACT_ROW_THREADS
    per = min(threads, max(32, 1 << max(0, (ku // 8).bit_length() - 1)))
    groups = threads // per
    while groups > 1 and groups * row_bytes > cap:
        groups //= 2
    held = min(ku, cap // (unit * itemsize))  # units of a row held: all, or its tail

    def per_sm(g):
        return 2 if 2 * (g * held * unit * itemsize + QUANT_ACT_SMEM_RESERVE) <= smem + 1024 \
            else 1

    most = max(32, 1 << max(0, ku - 1).bit_length())  # threads a row can use: one a unit
    while groups > 1 and -(-rows // groups) < sms * per_sm(groups) and \
            2 * threads // groups <= most:
        groups //= 2
    grid = min(sms * per_sm(groups), -(-rows // groups))
    return QuantPlan(per_row=True, vec=vec, unit=unit, on_chip=held == ku, grid=grid,
                     threads=threads, smem=groups * held * unit * itemsize, chunk=ku,
                     held=held, rows_per_block=groups, threads_per_row=threads // groups)


@functools.lru_cache(maxsize=None)
def _smem_per_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_multiprocessor


@functools.lru_cache(maxsize=None)
def _smem_per_block(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    return optin if optin else props.shared_memory_per_multiprocessor - 1024


_QUANT_SCRATCH: dict = {}


def _quant_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """Kernel F's grid-barrier scratch, one per (device, stream), zeroed
    once: the kernel leaves it as it found it."""
    key = (device.index, stream)
    buf = _QUANT_SCRATCH.get(key)
    if buf is None:
        buf = _QUANT_SCRATCH[key] = torch.zeros(QUANT_ACT_SCRATCH_WORDS, dtype=torch.int32,
                                                device=device)
    return buf


def _quant_act(fn, x: torch.Tensor, per_row: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Checks, plans and launches kernel F through the C function ``fn``
    (or the kernel of that name)."""
    _check(x, "x", (torch.float32, torch.bfloat16), x.dim())
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x has shape {tuple(x.shape)}: nothing to quantize")
    dev = x.device
    k = x.shape[-1] if per_row else x.numel()
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty((*x.shape[:-1], 1) if per_row else (), dtype=torch.float32, device=dev)
    unit = 16 // x.element_size()
    plan = plan_quant_act(tuple(x.shape), per_row, x.dtype, _n_sms(dev), _smem_per_block(dev),
                          aligned=x.data_ptr() % 16 == 0 and q.data_ptr() % unit == 0)
    stream = _stream(x)
    sync = None if per_row else _quant_scratch(dev, stream)
    if isinstance(fn, str):
        fn = kernel_function(fn)
    with _on(dev):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 None if sync is None else sync.data_ptr(), x.numel() // k, k, int(per_row),
                 int(x.dtype == torch.bfloat16), int(plan.vec), plan.chunk, plan.held,
                 plan.threads_per_row, plan.grid, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel 'quant_act' failed to launch: CUDA error {err} "
                           f"({plan})")
    return q, scale


def quant_act_cuda(x: torch.Tensor, per_row: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Activations (bf16 or f32, contiguous) → (int8 of x's shape, f32
    scale): one scale (shape ``()``) over the tensor, or one per row of the
    last axis (shape ``(..., 1)``), bit for bit ``ops.quant.quant_act``.
    One launch either way, planned by :func:`plan_quant_act`: per tensor a
    cooperative grid that holds what fits of the input on chip across its
    grid barrier (its scratch allocated once per device and stream), per row
    blocks that hold their rows on chip."""
    out = _quant_act("quant_act", x, per_row)
    quant_act_cuda.launches += 1
    return out


def _quant_half(fn, x: torch.Tensor, scale: torch.Tensor | None):
    """Checks, plans and launches one of kernel F's halves through the C
    function ``fn`` (or the kernel of that name): the scale of x where
    ``scale`` is None, else x quantized under it."""
    _check(x, "x", (torch.float32, torch.bfloat16), x.dim())
    if x.numel() == 0:
        raise ValueError(f"x has shape {tuple(x.shape)}: nothing to quantize")
    dev = x.device
    if scale is not None:
        _check(scale, "scale", (torch.float32,), scale.dim(), dev)
        if scale.numel() != 1:
            raise ValueError(f"scale has shape {tuple(scale.shape)}: one per tensor")
        out = torch.empty(x.shape, dtype=torch.int8, device=dev)
        aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % (16 // x.element_size()) == 0
    else:
        out = torch.empty((), dtype=torch.float32, device=dev)
        aligned = x.data_ptr() % 16 == 0
    plan = plan_quant_act((x.numel(),), False, x.dtype, _n_sms(dev), _smem_per_block(dev),
                          aligned=aligned)
    stream = _stream(x)
    name = fn if isinstance(fn, str) else getattr(fn, "__name__", "quant_act half")
    if isinstance(fn, str):
        fn = kernel_function(fn)
    bf16, vec = int(x.dtype == torch.bfloat16), int(plan.vec)
    with _on(dev):
        if scale is None:
            err = fn(x.data_ptr(), out.data_ptr(), _quant_scratch(dev, stream).data_ptr(),
                     x.numel(), bf16, vec, plan.chunk, plan.grid, stream)
        else:
            err = fn(x.data_ptr(), out.data_ptr(), scale.data_ptr(), x.numel(), bf16, vec,
                     plan.chunk, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: CUDA error {err} ({plan})")
    return out


def act_scale_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel F's first half: the f32 per-tensor scale (shape ``()``) of
    activations x (bf16 or f32, contiguous), bit for bit ``ops.quant.
    act_scale`` and the scale :func:`quant_act_cuda` computes.  One ordinary
    launch on the per-tensor plan's grid (nothing held on chip), whose last
    block merges the partial maxima in F's scratch."""
    out = _quant_half("quant_act_scale", x, None)
    act_scale_cuda.launches += 1
    return out


def quant_with_scale_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel F's second half: activations x (bf16 or f32, contiguous)
    quantized under one given f32 ``scale`` on the device → int8 of x's
    shape, bit for bit ``ops.quant.quant_with_scale`` for a scale that
    :func:`act_scale_cuda` (or a max of its results) gave: the set the bf16
    division is proved on.  One launch: x read once, the int8 written once."""
    out = _quant_half("quant_act_given", x, scale)
    quant_with_scale_cuda.launches += 1
    return out


def quant_div_check_cuda(device="cuda") -> dict:
    """Kernel F's bf16 division proved by exhaustion on the card
    (``mnc_quant_div_check``): every finite bf16 x against the scale of every
    non-negative finite bf16 absmax, the division-free int8 against
    ``__fdiv_rn``'s.  {"pairs", "mismatches", "first": (m bits, x bits) or
    None}."""
    dev = torch.device(device)
    out = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)
    with _on(dev):
        err = kernel_function("quant_div_check")(out.data_ptr(), _stream(out))
    if err != 0:
        raise RuntimeError(f"CUDA kernel 'quant_div_check' failed to launch: CUDA error {err}")
    bad, pairs, first = out.tolist()
    return {"pairs": pairs, "mismatches": bad,
            "first": None if first == -1 else (first >> 16, first & 0xffff)}


KERNELS = (roi_warp_cuda, roi_warp_bwd_cuda, nms_keep_cuda, paste_binarize_cuda, block1_cuda,
           gemm_s8_cuda, quant_act_cuda, act_scale_cuda, quant_with_scale_cuda)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
