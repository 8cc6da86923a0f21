#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mnc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the two JSON lines at the end:

1. device  — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build   — compiles every kernel from ``mnc_tpu_torch/csrc`` (nvcc, sm_90a).
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes of the serving path, then timed (CUDA events, after warm-up)
   beside the plain version and, where one PyTorch call computes the same
   function, that call.
4. main path — batched 5-stage VGG-16 serving at full width (640×1024
   canvas, FC 4096, pre-NMS 6000, post-NMS 304, bf16, seeded random init):
   ``MNCPipeline.detect_canvas_batch`` answers 3 requests of 4 canvases with
   the launch counters zeroed just before and read just after; then a small
   f32 model on the card is held against the same model on the CPU (plain
   versions of every kernel).
5. the ``kernels`` JSON line (launches of phase 4; times and errors of
   phase 3; bounds from this run's inputs), then ``{"ok": true, ...}``.

Any failure raises, so the script exits non-zero without the "ok" line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 without tensor cores
CANVAS = (640, 1024)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def random_boxes(g, n, h, w, lo=16.0, hi=500.0):
    """(n, 4) f32 boxes with corners up to 40 px beyond the canvas."""
    dev = "cuda"
    cx = torch.rand(n, generator=g, device=dev) * w
    cy = torch.rand(n, generator=g, device=dev) * h
    bw = lo + torch.rand(n, generator=g, device=dev) * (hi - lo)
    bh = lo + torch.rand(n, generator=g, device=dev) * (hi - lo)
    b = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return torch.maximum(torch.minimum(b, torch.tensor([w + 40.0, h + 40.0] * 2,
                                                       device=dev)),
                         torch.tensor(-40.0, device=dev))


def check_roi_warp(g):
    from mnc_tpu_torch.kernels import roi_warp_cuda
    from mnc_tpu_torch.ops.roi_warp import bin_centers, roi_warp_plain
    import torch.nn.functional as F

    b, n, (h, w, c), out_hw, s = 4, 304, (40, 64, 512), (14, 14), 1.0 / 16
    feat32 = torch.randn(b, h, w, c, generator=g, device="cuda")
    rois = torch.stack([random_boxes(g, n, *CANVAS) for _ in range(b)])
    result = {}
    for dt, tol_scale in ((torch.float32, 1e-5), (torch.bfloat16, 2 * 2.0 ** -7)):
        f = feat32.to(dt)
        got = roi_warp_cuda(f, rois, out_hw, s)
        want = roi_warp_plain(f, rois, out_hw, s)
        err = (got.float() - want.float()).abs().max().item()
        tol = tol_scale * f.float().abs().max().item()
        log(f"kernel A roi_warp {dt}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"roi_warp kernel disagrees with its plain version in {dt}")
        result[dt] = err
    f = feat32.to(torch.bfloat16)
    k_ms = cuda_ms(lambda: roi_warp_cuda(f, rois, out_hw, s))
    p_ms = cuda_ms(lambda: roi_warp_plain(f, rois, out_hw, s), iters=5)
    # the library yardstick: grid_sample over the same bin centers
    yc = bin_centers(rois, out_hw[0], s, 0)  # (B, N, PH)
    xc = bin_centers(rois, out_hw[1], s, 1)  # (B, N, PW)
    gy = (2 * yc + 1) / h - 1
    gx = (2 * xc + 1) / w - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, :, None, :], gy[:, :, :, None]), -1)
    grid = grid.reshape(b, n * out_hw[0], out_hw[1], 2).to(f.dtype)
    fn = f.permute(0, 3, 1, 2).contiguous()
    lib = lambda: F.grid_sample(fn, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                align_corners=False)
    l_ms = cuda_ms(lib)
    lib_err = (lib().reshape(b, c, n, *out_hw).permute(0, 2, 3, 4, 1).float()
               - roi_warp_cuda(f, rois, out_hw, s).float()).abs().max().item()
    log(f"kernel A roi_warp bf16 B={b} N={n}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms(grid_sample) {l_ms:.4f} (grid_sample vs kernel max diff {lib_err:.3e})")
    out_bytes = b * n * out_hw[0] * out_hw[1] * c * f.element_size()
    bms, by = bound_ms(nbytes(f, rois) + out_bytes, 8.0 * b * n * out_hw[0] * out_hw[1] * c)
    return dict(max_abs_err=result[torch.bfloat16], ms=k_ms, plain_ms=p_ms,
                bound_ms=bms, bound_by=by, library_ms=l_ms)


def _nms_case(g, p, k, cluster, invalid_frac, trailing):
    """Score-sorted boxes with exact score ties and invalid padding."""
    centers = random_boxes(g, p * cluster, *CANVAS, lo=24.0, hi=300.0).reshape(p, cluster, 4)
    pick = torch.randint(0, cluster, (p, k), generator=g, device="cuda")
    base = torch.gather(centers, 1, pick[..., None].expand(p, k, 4))
    jitter = (torch.rand(p, k, 4, generator=g, device="cuda") - 0.5) * 40.0
    boxes = base + jitter
    boxes[..., 2:] = torch.maximum(boxes[..., 2:], boxes[..., :2] + 1.0)
    u = torch.rand(p, k, generator=g, device="cuda")
    if trailing:  # the proposal layout: valid first, padding at the end
        n_valid = int(k * (1 - invalid_frac))
        valid = torch.arange(k, device="cuda").expand(p, k) < n_valid
    else:
        valid = u > invalid_frac
    scores = torch.round(torch.rand(p, k, generator=g, device="cuda") * 64) / 64  # ties
    return boxes.contiguous(), valid.contiguous(), scores


def _nms_bound(boxes, valid, keep, top_n):
    """Bytes and the IoU work this data needs: each kept box i is compared
    with every box after it up to where the scan stops."""
    p, k = keep.shape
    ar = torch.arange(k, device=keep.device)
    if top_n > 0:
        stop = torch.where(keep.sum(1) >= top_n,
                           (keep.cumsum(1) >= top_n).float().argmax(1), k - 1)
    else:
        stop = torch.full((p,), k - 1, device=keep.device)
    pairs = ((stop[:, None] - ar) * keep).clamp_min(0).sum().item()
    return bound_ms(nbytes(boxes, valid, keep), 16.0 * pairs)


def check_nms(g):
    from mnc_tpu_torch.kernels import nms_keep_cuda
    from mnc_tpu_torch.ops.nms import nms_indices, nms_keep_plain

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for label, (p, k, thresh, top_n, trailing) in {
            "proposal": (4, 6000, 0.7, 304, True),
            "per-class": (80, 304, 0.3, 0, False)}.items():
        boxes, valid, scores = _nms_case(g, p, k, cluster=max(k // 20, 4),
                                         invalid_frac=0.2, trailing=trailing)
        for tn in sorted({top_n, 0}):
            got = nms_keep_cuda(boxes, valid, thresh, tn)
            want = nms_keep_plain(boxes, valid, thresh, tn)
            if not torch.equal(got, want):
                raise AssertionError(f"nms kernel keeps differ ({label}, top_n={tn})")
            log(f"kernel B nms {label} P={p} K={k} thresh={thresh} top_n={tn}: "
                f"keeps identical ({int(got.sum())} kept)")
        # through nms_indices with tied, unsorted scores: CUDA (kernel) vs CPU (plain)
        chunk = 256 if top_n else None
        n_out = top_n or 64
        gi = nms_indices(boxes, scores, valid, thresh, n_out, chunk=chunk)
        ci = nms_indices(boxes.cpu(), scores.cpu(), valid.cpu(), thresh, n_out, chunk=chunk)
        if not (torch.equal(gi[0].cpu(), ci[0]) and torch.equal(gi[1].cpu(), ci[1])):
            raise AssertionError(f"nms_indices on the card differs from the CPU ({label})")
        log(f"kernel B nms_indices {label} with score ties: selections identical to the CPU")
        keep = nms_keep_cuda(boxes, valid, thresh, top_n)
        k_ms = cuda_ms(lambda: nms_keep_cuda(boxes, valid, thresh, top_n))
        p_ms = cuda_ms(lambda: nms_keep_plain(boxes, valid, thresh, top_n), iters=3,
                       warmup=1)
        bms, by = _nms_bound(boxes, valid, keep, top_n)
        log(f"kernel B nms {label}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {bms:.5f} ({by})")
        total["ms"] += k_ms
        total["plain_ms"] += p_ms
        total["bound_ms"] += bms
        bound_by.add(by)
    return dict(max_abs_err=0.0, **total, bound_by="operations" if "operations" in bound_by
                else "bytes", library_ms=None)


def check_paste(g):
    from mnc_tpu_torch.kernels import paste_binarize_cuda
    from mnc_tpu_torch.ops.masks import _paste_axis_weights, paste_binarize_plain

    n, m, (h, w), thresh = 100, 21, CANVAS, 0.4
    boxes = random_boxes(g, n, h, w, lo=20.0, hi=500.0)
    masks = torch.sigmoid(2 * torch.randn(n, m, m, generator=g, device="cuda"))
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], m, h).contiguous()
    wx = _paste_axis_weights(boxes[:, 0], boxes[:, 2], m, w)
    wxt = wx.transpose(1, 2).contiguous()
    got = paste_binarize_cuda(wy, masks, wxt, thresh)
    prod = torch.bmm(torch.bmm(wy, masks), wxt)
    mism = got != (prod > thresh)
    worst = (prod[mism] - thresh).abs().max().item() if mism.any() else 0.0
    log(f"kernel C paste N={n} {h}x{w}: {int(mism.sum())} pixels differ from the f32 "
        f"product, all within {worst:.2e} of the threshold (tolerance 1e-5)")
    if worst > 1e-5:
        raise AssertionError("paste kernel disagrees with its plain version")
    k_ms = cuda_ms(lambda: paste_binarize_cuda(wy, masks, wxt, thresh))
    p_ms = cuda_ms(lambda: paste_binarize_plain(wy, masks, wxt, thresh))
    l_ms = cuda_ms(lambda: torch.einsum("nhp,npq,nwq->nhw", wy, masks, wx) > thresh)
    log(f"kernel C paste: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms(einsum) {l_ms:.4f}")
    rows = (wy != 0).any(-1).sum(-1).double()  # canvas rows inside each box
    cols = (wxt != 0).any(-2).sum(-1).double()
    flops = (2.0 * m * m * rows + 2.0 * m * rows * cols).sum().item()
    bms, by = bound_ms(nbytes(wy, masks, wxt, got), flops)
    # for a bool output: the largest |product - threshold| of a differing pixel
    return dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                bound_ms=bms, bound_by=by, library_ms=l_ms)


def main_path(device_label):
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(pre_nms_top_n=6000, post_nms_top_n=304, nms_chunk=256,
                   compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = MNC(arch, device="cuda", seed=0)
    pipe = MNCPipeline(model, PostCfg.from_cfg(dets_per_class=16))
    log(f"main path: model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, bf16)")
    g = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    reqs = [torch.randint(0, 256, (b, *arch.canvas, 3), generator=g, device="cuda",
                          dtype=torch.uint8) for _ in range(4)]
    infos = torch.tensor([[640.0, 1024.0, 1.0]] * b, device="cuda")
    pipe.detect_canvas_batch(reqs[3], infos)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    k = pipe.post.max_per_image
    shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k),
              "masks": (b, k, arch.mask_size, arch.mask_size), "valid": (b, k),
              "canvas_masks": (b, k, *arch.canvas)}

    def check(out):
        for key, shp in shapes.items():
            if tuple(out[key].shape) != shp:
                raise AssertionError(f"{key} has shape {tuple(out[key].shape)}, want {shp}")
        for key in ("boxes", "scores", "masks"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key} is not finite")
        if not out["valid"].any() or out["canvas_masks"].dtype != torch.bool:
            raise AssertionError("no valid detection / canvas masks not bool")
        cls = out["classes"]
        if not ((cls >= 1) & (cls < arch.num_classes)).all():
            raise AssertionError("classes out of range")
        return int(out["valid"].sum())

    # each request's result is checked after its timing and then dropped, as
    # a server hands it on, so later requests reuse the same device memory
    lat, n_valid = [], []
    for r in range(3):
        t0 = time.perf_counter()
        out = pipe.detect_canvas_batch(reqs[r], infos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        n_valid.append(check(out))
        del out
    counts = launch_counts()
    log(f"main path: launches {counts}; valid detections per request {n_valid}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main path on {device_label}: latency per request of {b} canvases "
        + ", ".join(f"{x * 1e3:.1f} ms" for x in lat)
        + f"; {3 * b / sum(lat):.2f} img/s")
    return counts


def small_model_agrees():
    """A small f32 model on the card vs the same weights on the CPU, where
    every kernel runs its plain version."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, compute_dtype=torch.float32, fc_dim=64, mask_fc_dim=32,
                   pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0)
    post = PostCfg(dets_per_class=4, max_per_image=8)
    g = torch.Generator().manual_seed(2)
    imgs = torch.randint(0, 256, (2, 96, 128, 3), generator=g, dtype=torch.uint8)
    infos = torch.tensor([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]])
    gpu = MNCPipeline(MNC(arch, device="cuda", seed=3), post).detect_canvas_batch(imgs, infos)
    cpu = MNCPipeline(MNC(arch, device="cpu", seed=3), post).detect_canvas_batch(imgs, infos)
    for key in ("valid", "classes"):
        if not torch.equal(gpu[key].cpu(), cpu[key]):
            raise AssertionError(f"small model: {key} differs between card and CPU")
    errs = {key: (gpu[key].cpu() - cpu[key]).abs().max().item()
            for key in ("boxes", "scores", "masks")}
    flips = (gpu["canvas_masks"].cpu() != cpu["canvas_masks"]).float().mean().item()
    log(f"small f32 model, card vs CPU: selections identical; max abs diff {errs}; "
        f"canvas pixels differing {flips:.2e}")
    if errs["boxes"] > 1e-2 or errs["scores"] > 1e-4 or errs["masks"] > 1e-3 or flips > 1e-3:
        raise AssertionError("small model: card and CPU disagree beyond tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from mnc_tpu_torch import kernels

    t0 = time.perf_counter()
    paths = kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        usage = [ln.strip() for ln in (log_path.read_text().splitlines()
                                       if log_path.exists() else []) if "registers" in ln]
        log(f"build {name}: " + ("; ".join(usage) or "cached"))

    # phase 3: kernels against their plain versions
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {"roi_warp": check_roi_warp(g), "nms": check_nms(g),
               "paste_binarize": check_paste(g)}

    # phase 4: the main path
    counts = main_path(f"{torch.cuda.get_device_name(0)} ({smi})")
    small_model_agrees()

    # phase 5: report
    meta = {
        "roi_warp": ("roi_warp_cuda", "mnc_tpu_torch/csrc/roi_warp.cu",
                     "mnc_tpu/ops/pallas/roi_warp_kernel.py:142"),
        "nms": ("nms_keep_cuda", "mnc_tpu_torch/csrc/nms.cu",
                "mnc_tpu/ops/pallas/nms_kernel.py:65"),
        "paste_binarize": ("paste_binarize_cuda", "mnc_tpu_torch/csrc/paste.cu",
                           "mnc_tpu/ops/pallas/paste_kernel.py:92"),
    }
    report = []
    for name, (wrapper, source, replaces) in meta.items():
        if counts[wrapper] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        report.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                           launches=counts[wrapper], **results[name]))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
