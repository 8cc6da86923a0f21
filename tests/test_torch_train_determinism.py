"""Training on the port is a pure function of (state, batch, draws), as the
JAX package's is (``tests/test_checkpoint.py::test_training_is_deterministic``).

On the card two things could break that, and both are covered here at
small sizes on the CPU:

- kernel A′ (``csrc/roi_warp_bwd.cu``) sums dF by map tile, over the RoIs
  that its first launch lists for the tile in ascending index.  Its plain
  twins (``kernels.roi_warp_bwd_lists``, ``kernels.roi_warp_bwd_plan``) are
  held against a brute-force enumeration of every tap that
  ``roi_warp_plain`` touches, and a plain sum of dF that follows the lists
  and the splits in the kernel's order against the autograd dF of
  ``roi_warp_plain`` (f32, 1e-5 of the max, as ``chip_smoke.py`` holds the
  kernel);
- cuDNN: every train step enters ``train.loop.deterministic_cudnn``.  A
  module's forward hook records the flags inside the build_train_step, CFM
  and DP (gloo, world 1) steps, and every flag must be as it was after.

Then two steps from one state give bit-equal parameters, momenta and
metrics, the counterpart of the JAX test above.
"""

import numpy as np
import pytest
import torch

from mnc_tpu_torch.data.synthetic import SyntheticShapes
from mnc_tpu_torch.kernels import (ROI_WARP_BWD_MAX_SPLITS, ROI_WARP_BWD_TILE,
                                   roi_warp_bwd_lists, roi_warp_bwd_plan, roi_warp_bwd_tiles)
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.ops.roi_warp import bin_centers, roi_warp_plain
from mnc_tpu_torch.train.loop import (TrainState, deterministic_cudnn, draw_step_randoms,
                                      make_train_step)
from mnc_tpu_torch.train.optim import make_optimizer
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

H, W, SCALE = 12, 16, 0.25  # a 48 x 64 image at stride 4
_f = np.float32


def _box_sets():
    """Seeded RoIs on a 48 x 64 image, (1, N, 4) each: a random mix with
    integer-coordinate bin centers among them, boxes over the map's edge,
    wholly outside, 1 px, the full canvas, one upside down, and many small
    boxes crowded on a few cells."""
    rs = np.random.RandomState(17)
    xy = rs.uniform(-10, [60, 44], size=(20, 2))
    wh = rs.uniform(2, 50, size=(20, 2))
    mixed = np.concatenate([xy, xy + wh], 1)
    special = np.array([[8.0, 4.0, 23.0, 19.0],      # bin centers on integers at 4 x 4 bins
                        [-4.0, 36.0, 11.0, 51.0],    # the same, over the bottom-left edge
                        [0.0, 0.0, 63.0, 47.0],      # the full canvas
                        [20.0, 17.0, 20.0, 17.0],    # 1 px
                        [-60.0, -60.0, -30.0, -30.0],  # wholly outside
                        [100.0, 5.0, 130.0, 25.0],   # wholly outside, right
                        [-9.0, -7.5, 14.0, 11.0],    # over the top-left corner
                        [-30.0, 10.0, 90.0, 13.0],   # wider than the map
                        [10.0, 40.0, 40.0, 8.0]])    # y2 < y1: centers move up the map
    c = 24.0 + rs.uniform(0, 10, size=(16, 2))
    half = rs.uniform(0.2, 2.0, size=(16, 2))
    crowded = np.concatenate([c - half, c + half], 1)
    return {"mixed": np.concatenate([mixed, special]), "crowded": crowded,
            "special": special}


def _taps(rois, out_hw):
    """Brute force, per RoI: the set of cells (h, w) where ``roi_warp_plain``'s
    hat weights are both positive for some bin (p, q), and the rows and
    columns floor - 1 .. floor + 1 around every bin center (the taps that
    its derivative reads), in the kernel's f32 arithmetic."""
    out = []
    for x1, y1, x2, y2 in rois.astype(_f):
        def centers(lo, hi, bins):
            span = _f(_f(_f(hi - lo) + _f(1.0)) * _f(SCALE))
            return [_f(_f(_f(lo * _f(SCALE)) + _f(_f(_f(_f(i) + _f(0.5)) / _f(bins)) * span))
                       - _f(0.5)) for i in range(bins)]

        ys, xs = centers(y1, y2, out_hw[0]), centers(x1, x2, out_hw[1])
        pos = {(h, w) for yc in ys for xc in xs for h in range(H) for w in range(W)
               if _f(1.0) - abs(_f(yc - _f(h))) > 0 and _f(1.0) - abs(_f(xc - _f(w))) > 0}
        near = {(h, w) for yc in ys for xc in xs if not (np.isnan(yc) or np.isnan(xc))
                for h in range(int(np.floor(yc)) - 1, int(np.floor(yc)) + 2)
                for w in range(int(np.floor(xc)) - 1, int(np.floor(xc)) + 2)
                if 0 <= h < H and 0 <= w < W}
        out.append((pos, near))
    return out


def _tile_of(h, w):
    th, tw = ROI_WARP_BWD_TILE
    return (h // th) * roi_warp_bwd_tiles((H, W))[1] + w // tw


@pytest.mark.parametrize("out_hw", [(4, 4), (7, 5), (14, 14)])
@pytest.mark.parametrize("kind", ["mixed", "crowded", "special"])
def test_tile_lists_hold_every_tap_in_roi_order(kind, out_hw):
    """Every cell that a RoI's hat weights reach lies in a tile whose list
    holds the RoI; a listed RoI's taps (floor - 1 .. floor + 1 of its bin
    centers) reach within one line of the tile (the lists bound each axis
    by its first and last center); each list is in ascending RoI index and
    its count is its length."""
    rois = torch.tensor(_box_sets()[kind], dtype=torch.float32)[None]
    counts, lists = roi_warp_bwd_lists(rois, out_hw, SCALE, (H, W))
    n_tiles = int(np.prod(roi_warp_bwd_tiles((H, W))))
    assert counts.shape == (1, n_tiles) and lists.shape == (1, n_tiles, rois.shape[1])
    listed = [set(lists[0, t, :int(counts[0, t])].tolist()) for t in range(n_tiles)]
    for t in range(n_tiles):
        row = lists[0, t]
        k = int(counts[0, t])
        assert (row[k:] == -1).all() and bool((row[:k] >= 0).all())
        assert torch.equal(row[:k], torch.sort(row[:k]).values) and len(listed[t]) == k
    th, tw = ROI_WARP_BWD_TILE
    ntw = roi_warp_bwd_tiles((H, W))[1]
    for n, (pos, near) in enumerate(_taps(rois[0].numpy(), out_hw)):
        for h, w in pos:
            assert n in listed[_tile_of(h, w)], (n, h, w)
        for t in range(n_tiles):
            if n in listed[t] and near:
                r0, c0 = (t // ntw) * th, (t % ntw) * tw
                hs = [h for h, _ in near]
                ws = [w for _, w in near]
                assert min(hs) - 1 <= r0 + th - 1 and max(hs) + 1 >= r0, (n, t)
                assert min(ws) - 1 <= c0 + tw - 1 and max(ws) + 1 >= c0, (n, t)
        if not near:  # wholly outside: listed nowhere
            assert all(n not in s for s in listed)


def test_tile_lists_follow_roi_index_only():
    """The lists are a function of the boxes alone: a box's place in every
    list moves with its index when the RoIs are permuted, and the listed
    sets are the same."""
    rois = torch.tensor(_box_sets()["mixed"], dtype=torch.float32)[None]
    perm = torch.randperm(rois.shape[1], generator=torch.Generator().manual_seed(3))
    counts, lists = roi_warp_bwd_lists(rois, (7, 7), SCALE, (H, W))
    pc, pl = roi_warp_bwd_lists(rois[:, perm], (7, 7), SCALE, (H, W))
    assert torch.equal(counts, pc)
    for t in range(counts.shape[1]):
        k = int(counts[0, t])
        assert torch.equal(torch.sort(perm[pl[0, t, :k]]).values, lists[0, t, :k])


def test_plan_splits_crowded_tiles_within_its_budget():
    """A tile of count RoIs gets floor(count · E / total) splits, at least one
    and at most MAX_SPLITS and its count; the units number on from tile to
    tile, and their sum stays within tiles + E (the kernel's scratch)."""
    counts = torch.tensor([0, 1, 5, 40, 200, 3000, 7])
    splits, base = roi_warp_bwd_plan(counts)
    assert splits.tolist()[:3] == [1, 1, 1] and splits[5] == ROI_WARP_BWD_MAX_SPLITS
    assert torch.equal(base, torch.cumsum(splits, 0) - splits)
    assert int(splits.sum()) <= counts.numel() + 512
    assert bool((splits <= counts.clamp(min=1)).all())


def tile_gather_dfeat(grad, rois, out_hw, scale, map_hw):
    """dF as kernel A′ sums it, in f32: per image and tile, each split of
    the tile's list (``roi_warp_bwd_plan``) sums its RoIs in list order and,
    per RoI, the bins p, then q, whose hats reach the cell; the splits are
    added in order.  grad (B, N, PH, PW, C) → (B, H, W, C)."""
    b, n, ph, pw, c = grad.shape
    h, w = map_hw
    th, tw = ROI_WARP_BWD_TILE
    nth, ntw = roi_warp_bwd_tiles(map_hw)
    counts, lists = roi_warp_bwd_lists(rois, out_hw, scale, map_hw)
    splits, _ = roi_warp_bwd_plan(counts)
    yc, xc = bin_centers(rois, ph, scale, 0), bin_centers(rois, pw, scale, 1)
    out = torch.zeros(b, h, w, c)
    g = grad.float()
    for i in range(b):
        for t in range(nth * ntw):
            rows = torch.arange((t // ntw) * th, min((t // ntw + 1) * th, h))
            cols = torch.arange((t % ntw) * tw, min((t % ntw + 1) * tw, w))
            count, sp = int(counts[i, t]), int(splits[i * nth * ntw + t])
            total = None
            for s in range(sp):
                acc = torch.zeros(len(rows), len(cols), c)
                for r in lists[i, t, s * count // sp:(s + 1) * count // sp].tolist():
                    hy = 1.0 - (yc[i, r][:, None] - rows.float()).abs()  # (PH, rows)
                    hx = 1.0 - (xc[i, r][:, None] - cols.float()).abs()  # (PW, cols)
                    for p in range(ph):
                        for q in range(pw):
                            wgt = (hy[p].clamp(min=0)[:, None] * hx[q].clamp(min=0)[None])
                            if wgt.any():
                                acc = acc + wgt[..., None] * g[i, r, p, q]
                total = acc if total is None else total + acc
            out[i, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = total
    return out


@pytest.mark.parametrize("out_hw", [(4, 4), (7, 5)])
@pytest.mark.parametrize("kind", ["mixed", "crowded"])
def test_tile_order_sum_equals_the_plain_gradient(kind, out_hw):
    """The tile gather in the kernel's order gives autograd's dF through
    ``roi_warp_plain`` within 1e-5 of its max (f32), and the crowded set
    exercises tiles of several splits."""
    rs = np.random.RandomState(5)
    rois = torch.tensor(_box_sets()[kind], dtype=torch.float32)[None]
    n = rois.shape[1]
    feat = torch.tensor(rs.randn(1, H, W, 8).astype(np.float32), requires_grad=True)
    cot = torch.tensor(rs.randn(1, n, *out_hw, 8).astype(np.float32))
    (want,) = torch.autograd.grad(roi_warp_plain(feat, rois, out_hw, SCALE), feat, cot)
    got = tile_gather_dfeat(cot, rois, out_hw, SCALE, (H, W))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    if kind == "crowded":
        counts, _ = roi_warp_bwd_lists(rois, out_hw, SCALE, (H, W))
        assert int((roi_warp_bwd_plan(counts)[0] > 1).sum()) > 0


# ---- cuDNN held to deterministic algorithms in every train step ------------

TRAIN_CFG = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                 RPN_FG_FRACTION=0.5, BATCH_SIZE=8, FG_FRACTION=0.25, FG_THRESH=0.5,
                 BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
SMALL = dict(canvas=(64, 96), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9, warp_hw=4,
             fc_dim=32, mask_fc_dim=16, pre_nms_top_n=96, post_nms_top_n=24, rpn_min_size=4.0,
             compute_dtype=torch.float32)
FLAGS = ("enabled", "benchmark", "benchmark_limit", "deterministic", "allow_tf32")


def _flags():
    return {k: getattr(torch.backends.cudnn, k) for k in FLAGS}


def _setup(seed=1):
    arch = MNCArch(**SMALL)
    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=4, max_gt=4, gt_mask_size=16,
                           n_range=(1, 3), seed=3)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([0, 1]).items()}
    model = MNC(arch, device="cpu", seed=seed, train=True)
    opt = make_optimizer(model)
    return arch, batch, model, opt, TrainState.create(model, opt)


def _recording(model):
    """Records the cuDNN flags in a forward hook of the trunk."""
    seen = []
    model.trunk.register_forward_hook(lambda *a: seen.append(_flags()))
    return seen


@pytest.fixture
def odd_flags():
    """cuDNN flags unlike the helper's and unlike their defaults, restored
    after the test."""
    cudnn = torch.backends.cudnn
    before = _flags()
    cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = True, False, False
    yield _flags()
    for k, v in before.items():
        setattr(cudnn, k, v)


def test_deterministic_cudnn_sets_two_flags_and_restores_all(odd_flags):
    with deterministic_cudnn():
        inside = _flags()
    assert _flags() == odd_flags
    assert inside == dict(odd_flags, deterministic=True, benchmark=False)
    with pytest.raises(RuntimeError):  # restored on an exception too
        with deterministic_cudnn():
            raise RuntimeError
    assert _flags() == odd_flags


def _build_step(model, opt, arch):
    return make_train_step(model, opt, arch, TRAIN_CFG)


def _cfm_step(model, opt, arch):
    from mnc_tpu_torch.models.cfm import build_cfm_train_step

    return build_cfm_train_step(model, opt, arch, TRAIN_CFG)


def _dp_step(model, opt, arch):
    from mnc_tpu_torch.parallel import data_parallel_train_step, make_mesh

    return data_parallel_train_step(model, opt, arch, TRAIN_CFG, make_mesh(device="cpu"))


def _cfm_batch(arch, batch):
    """Each image's gt boxes and masks as its segments (oracle proposals)."""
    return dict(batch, seg_boxes=batch["gt_boxes"], seg_masks=batch["gt_masks"],
                seg_valid=batch["gt_valid"])


@pytest.mark.parametrize("kind", ["build_train_step", "cfm", "dp_gloo_world1"])
def test_train_steps_run_under_deterministic_cudnn_and_restore_the_flags(kind, odd_flags):
    import torch.distributed as dist

    arch, batch, model, opt, state = _setup()
    seen = _recording(model)
    make = {"build_train_step": _build_step, "cfm": _cfm_step,
            "dp_gloo_world1": _dp_step}[kind]
    try:
        step = make(model, opt, arch)
        if kind == "cfm":
            batch = _cfm_batch(arch, batch)
        _, metrics = step(state, batch, torch.Generator().manual_seed(5))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert seen and all(s == dict(odd_flags, deterministic=True, benchmark=False)
                        for s in seen)
    assert _flags() == odd_flags


def _snapshot(model, opt, state):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            [t.clone() for t in opt.trace], opt.count, state.step)


def _restore(model, opt, state, snap):
    params, trace, count, step = snap
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    for t, s in zip(opt.trace, trace):
        t.copy_(s)
    opt.count, state.step = count, step


def test_training_is_deterministic():
    """Two steps from one state, one batch and one draw (the second after
    restoring the state in place): bit-equal parameters, momenta and
    metrics, the port's ``tests/test_checkpoint.py::test_training_is_deterministic``.
    The 5-stage cascade, so the gradient crosses kernel A′'s plain twin
    into the box coordinates twice."""
    arch, batch, model, opt, state = _setup()
    assert arch.n_stages == 5
    step = make_train_step(model, opt, arch, TRAIN_CFG)
    draws = draw_step_randoms(torch.Generator().manual_seed(5), arch, TRAIN_CFG, 2, 4)
    step(state, batch, draws)  # momenta of one step, so the second carries a trace
    snap = _snapshot(model, opt, state)
    runs = []
    for _ in range(2):
        _restore(model, opt, state, snap)
        _, m = step(state, batch, draws)
        runs.append((_snapshot(model, opt, state), {k: float(v) for k, v in m.items()}))
    (a, ma), (b, mb) = runs
    assert ma == mb
    for n in a[0]:
        assert torch.equal(a[0][n], b[0][n]), n
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[2:] == b[2:] == (snap[2] + 1, snap[3] + 1)
    moved = sum(not torch.equal(a[0][n], snap[0][n]) for n in a[0])
    assert moved > len(a[0]) // 2
