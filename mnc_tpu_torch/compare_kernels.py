"""Time the redesigned kernels — A (RoI warp), B (NMS), A′ (RoI-warp
backward), C (paste + binarize), D (fused VGG block 1), E (the int8 GEMM), F
(the int8 activation quantization) — against earlier or differently tuned
builds of themselves (F also against plain ``quant_act``), on one GPU,
inside one process.

    python3 -m mnc_tpu_torch.compare_kernels [--parent-csrc DIR] [--only paste,block1]
        [--roi-warp-variant=-DFLAG] [--roi-warp-plan cell_chunks=2,band_rows=13]
        [--roi-warp-source LABEL=PATH]
        [--nms-variant=-DMNC_NMS_CLUSTER=8] [--bwd-variant=-DMNC_RWB_TILE_H=8]
        [--paste-variant=-DMNC_PASTE_BAND=64] [--block1-variant=-DMNC_B1_PRODUCERS=1]
        [--gemm-s8-variant=-DMNC_S8_STAGES_128=3] [--bwd-source LABEL=PATH]
        [--paste-source LABEL=PATH] [--block1-source LABEL=PATH]
        [--gemm-s8-source LABEL=PATH] [--profile] [--out FILE.json]

Run it from the repository's root (it borrows ``chip_smoke.py``'s inputs and
timer).  Two runs on two cards, or at two times, cannot be compared, so every
build is timed in one call, in the order given and then in reverse (parent,
change, ..., change, parent), each after its outputs were held against the
plain PyTorch version (A: within 1e-5 of max|F| in f32 and 2 bf16 ulps of
it in bf16, at every shape of ``chip_smoke.ROI_WARP_SHAPES`` and at phase
4a's proposals, whose L2 tap bytes under the first port's design and today's
are printed beside the times; C: binarization equal except within 1e-5 of the
threshold; D: ``block1_tolerance`` with >= 0.999 bit-identical; E and F:
bit for bit; E at every shape of ``chip_smoke.GEMM_S8_SHAPES``, F in bf16 at
every int8 layer's input of both trunks, ``chip_smoke.int8_layer_inputs``).

``--parent-csrc DIR`` names a directory holding the parent commit's sources
(``git show <commit>:mnc_tpu_torch/csrc/paste.cu > DIR/paste.cu``); each of
``roi_warp.cu``, ``nms.cu``, ``roi_warp_bwd.cu``, ``paste.cu``, ``block1.cu``,
``gemm_s8.cu`` and ``quant_act.cu`` found there is built and timed.
``roi_warp.cu`` must have the first port's C interface (``93b6a8c``: a block
per output row, no plan); ``nms.cu`` today's; ``roi_warp_bwd.cu`` the
atomic version's (``5b489d4``: one float atomic per footprint cell into a
zeroed f32 map, which the caller casts);
``paste.cu`` and ``block1.cu`` the first port's (no extent scratch; HWIO weights),
``gemm_s8.cu`` its first version's (``2cac255``: unpacked weights, no plan),
``quant_act.cu`` its first version's (``c02edfa``: two launches a tensor, a
partial buffer), and are driven exactly as their wrappers drove them (D's
weights permuted and cast on every call; F's partial buffer allocated on
every call).  Each ``--*-variant``
(repeatable) builds the current source with extra ``nvcc`` flags (the macros
at the head of each source), which is how cluster sizes, block sizes, bands
and grids are settled; ``--*-source`` times another source file that has
today's interface; ``--roi-warp-plan`` (repeatable) times today's kernel A
under another plan (``plan_roi_warp``'s ``cell_chunks`` and ``band_rows``).
A is timed over a CUDA graph of 20 calls (``chip_smoke.cuda_graph_ms``):
back to back from the host, its wrapper's host work paces the small shapes.
``--profile`` also lists, per build, the device time of each CUDA kernel it
launched (``torch.profiler``).  A build whose outputs are
wrong is reported, timed all the same, and fails the run at its end.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mnc_tpu_torch.kernels import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
PARENT_ABI = {  # the C interfaces of the parent commit's sources
    # A's first version (93b6a8c): a block per (image, RoI, output row), no plan
    "roi_warp": ("roi_warp.cu", "mnc_roi_warp_fwd",
                 [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "nms": _build.KERNEL_ABI["nms"],
    # A′'s atomic version (5b489d4): dF added into a zeroed f32 map, no scratch
    "roi_warp_bwd": ("roi_warp_bwd.cu", "mnc_roi_warp_bwd",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "paste_binarize": ("paste.cu", "mnc_paste_binarize",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "block1": _build.KERNEL_ABI["block1"],
    # E's first version (mma.sync, 2cac255): unpacked weights, a 16-byte-loader flag
    "gemm_s8": ("gemm_s8.cu", "mnc_gemm_s8", [_P, _P, _P, _I, _P, _P, _P] + [_I] * 14 + [_P]),
    # F's first version (c02edfa): two launches a tensor, a partial buffer, the SM count
    "quant_act": ("quant_act.cu", "mnc_quant_act", [_P, _P, _P, _P, _L, _L, _I, _I, _I, _P]),
}
QUANT_ACT_PARTIALS = 2048  # the first version's partial maxima (its kMaxPartials)
KINDS = ("roi_warp", "nms", "roi_warp_bwd", "paste", "block1", "gemm_s8", "quant_act")


def load(source: Path, abi, flags=()):
    """Compile ``source`` with the port's flags plus ``flags``; the C function."""
    nvcc = _build.nvcc_path()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libcompare-{source.stem}-{tag}.so"
    if not lib.exists():
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} {flags}:\n{proc.stdout}{proc.stderr}")
        print(f"build {source} {' '.join(flags)}:\n{proc.stdout}{proc.stderr}", flush=True)
    fn = getattr(ctypes.CDLL(str(lib)), abi[1])
    fn.argtypes, fn.restype = abi[2], ctypes.c_int
    return fn


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _parent(args, name):
    """The parent's source of ``name`` if --parent-csrc holds it, else None."""
    if not args.parent_csrc:
        return None
    path = Path(args.parent_csrc) / PARENT_ABI[name][0]
    return path if path.exists() else None


def _sources(args, name, flags_list, extra):
    """[(label suffix, source, flags)]: extra sources, then today's with each variant."""
    out = []
    for spec in extra:
        label, _, path = spec.partition("=")
        out.append((label, Path(path), []))
    for flags in [""] + flags_list:
        out.append((flags, _build.CSRC / _build.KERNEL_ABI[name][0], shlex.split(flags)))
    return out


def roi_warp_callers(args):
    """{label: f(features, rois, out_hw, scale) -> (B, N, PH, PW, C)}: the
    first version as its wrapper drove it (a grid of (PH, N, B) blocks),
    today's source through ``kernels._roi_warp`` under its plan and under
    each ``--roi-warp-plan``."""
    from mnc_tpu_torch.kernels import _roi_warp, plan_roi_warp

    def make_parent(fn):
        def call(f, rois, out_hw, scale):
            b, h, w, c = f.shape
            n = rois.shape[1]
            out = torch.empty((b, n, *out_hw, c), dtype=f.dtype, device=f.device)
            _ok(fn(f.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, n, *out_hw, scale,
                   0 if f.dtype == torch.float32 else 1, _stream()), "roi_warp")
            return out
        return call

    def make(fn, overrides=None):
        def call(f, rois, out_hw, scale):
            plan = None
            if overrides:
                b, h, w, c = f.shape
                plan = plan_roi_warp(b, rois.shape[1], c, f.dtype, tuple(out_hw), (h, w),
                                     **overrides)
            return _roi_warp(fn, f, rois, out_hw, scale, plan)
        return call

    callers = {}
    parent = _parent(args, "roi_warp")
    if parent:
        callers["parent (a block per output row)"] = make_parent(
            load(parent, PARENT_ABI["roi_warp"]))
    abi = _build.KERNEL_ABI["roi_warp"]
    for suffix, src, flags in _sources(args, "roi_warp", args.roi_warp_variant,
                                       args.roi_warp_source):
        callers[f"map slabs staged {suffix}".strip()] = make(load(src, abi, flags))
    for spec in args.roi_warp_plan:
        overrides = {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
        callers[f"map slabs staged, plan {spec}"] = make(load(_build.CSRC / abi[0], abi),
                                                         overrides)
    return callers


def nms_callers(args):
    """{label: f(boxes, valid, thresh, top_n) -> keep}."""
    def make(fn):
        def call(boxes, valid, thresh, top_n):
            p, k, _ = boxes.shape
            keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
            _ok(fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), p, k, thresh, top_n,
                   _stream()), "nms")
            return keep
        return call

    callers = {}
    parent = _parent(args, "nms")
    if parent:
        callers["parent"] = make(load(parent, PARENT_ABI["nms"]))
    for suffix, src, flags in _sources(args, "nms", args.nms_variant, []):
        callers[f"chunked scan {suffix}".strip()] = make(load(src, _build.KERNEL_ABI["nms"],
                                                              flags))
    return callers


def bwd_callers(args):
    """{label: f(grad, feat, rois, scale) -> (dF in the feature dtype, d rois)}."""
    from mnc_tpu_torch.kernels import ROI_WARP_BWD_EXTRA_UNITS, roi_warp_bwd_scratch

    def make(fn, atomic):
        def call(go, f, rois, scale):
            b, h, w, c = f.shape
            n, (ph, pw) = rois.shape[1], go.shape[2:4]
            dt = 0 if f.dtype == torch.float32 else 1
            out = torch.empty((b, n, 4), dtype=torch.float32, device=f.device)
            if atomic:  # the parent: a zeroed f32 map, cast after
                dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=f.device)
                _ok(fn(go.data_ptr(), f.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
                       out.data_ptr(), b, h, w, c, n, ph, pw, scale, dt, _stream()),
                    "roi_warp_bwd")
                return dfeat.to(f.dtype), out
            # scratch for any tile of at most 32 cells (a --bwd-variant may change the
            # tile): lists of one-cell tiles, partials of E 32-cell units beyond the map
            n_ints, _ = roi_warp_bwd_scratch(b, n, (h, w), c, (ph, pw))
            n_ints += b * h * w * (n + 4)
            n_partial = (b * h * w + ROI_WARP_BWD_EXTRA_UNITS * 32) * c + b * n * (ph + pw)
            dfeat = torch.empty((b, h, w, c), dtype=f.dtype, device=f.device)
            ints = torch.empty(n_ints, dtype=torch.int32, device=f.device)
            partial = torch.empty(n_partial, dtype=torch.float32, device=f.device)
            _ok(fn(go.data_ptr(), f.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
                   out.data_ptr(), ints.data_ptr(), partial.data_ptr(), b, h, w, c, n, ph, pw,
                   scale, dt, _stream()), "roi_warp_bwd")
            return dfeat, out
        return call

    abi = _build.KERNEL_ABI["roi_warp_bwd"]
    callers = {}
    parent = _parent(args, "roi_warp_bwd")
    if parent:
        callers["parent"] = make(load(parent, PARENT_ABI["roi_warp_bwd"]), True)
    for suffix, src, flags in _sources(args, "roi_warp_bwd", args.bwd_variant,
                                       args.bwd_source):
        callers[f"tile gather {suffix}".strip()] = make(load(src, abi, flags), False)
    return callers


def paste_callers(args):
    """{label: f(wy, masks, wxt, thresh) -> bool canvases}."""
    def make(fn, with_extent):
        def call(wy, masks, wxt, thresh):
            n, h, m = wy.shape
            w = wxt.shape[2]
            out = torch.empty((n, h, w), dtype=torch.bool, device=wy.device)
            ptrs = [wy.data_ptr(), masks.data_ptr(), wxt.data_ptr()]
            if with_extent:
                ptrs.append(torch.empty((n, 4), dtype=torch.int32, device=wy.device).data_ptr())
            _ok(fn(*ptrs, out.data_ptr(), n, h, w, m, thresh, _stream()), "paste")
            return out
        return call

    callers = {}
    parent = _parent(args, "paste_binarize")
    if parent:
        callers["parent (32 x 128 tiles)"] = make(load(parent, PARENT_ABI["paste_binarize"]),
                                                  with_extent=False)
    for suffix, src, flags in _sources(args, "paste_binarize", args.paste_variant,
                                       args.paste_source):
        callers[f"extents + bands {suffix}".strip()] = make(
            load(src, _build.KERNEL_ABI["paste_binarize"], flags), with_extent=True)
    return callers


def block1_callers(args):
    """{label: f(x, w1, b1, w2, b2) -> (B, H/2, W/2, 64) bf16}, OIHW weights."""
    from mnc_tpu_torch.ops.block1 import packed_block1_weights

    bf = torch.bfloat16

    def launch(fn, x, w1, b1, w2, b2):
        b, h, w, _ = x.shape
        out = torch.empty((b, h // 2, w // 2, 64), dtype=bf, device=x.device)
        _ok(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
               out.data_ptr(), b, h, w, _stream()), "block1")
        return out

    def parent_call(x, w1, b1, w2, b2, fn=None):
        # as the first port's Block1Function.forward drove it: cast and permute per call
        hwio = lambda w: w.to(bf).permute(2, 3, 1, 0).contiguous()  # noqa: E731
        return launch(fn, x.to(bf).contiguous(), hwio(w1), b1.to(bf), hwio(w2), b2.to(bf))

    def make(fn):
        def call(x, w1, b1, w2, b2):
            return launch(fn, x.to(bf).contiguous(), *packed_block1_weights(w1, b1, w2, b2))
        return call

    callers = {}
    parent = _parent(args, "block1")
    if parent:
        fn = load(parent, PARENT_ABI["block1"])
        callers["parent (wmma, a block per tile)"] = (
            lambda *a, fn=fn: parent_call(*a, fn=fn))
    for suffix, src, flags in _sources(args, "block1", args.block1_variant,
                                       args.block1_source):
        callers[f"wgmma, persistent {suffix}".strip()] = make(
            load(src, _build.KERNEL_ABI["block1"], flags))
    return callers


def gemm_s8_callers(args):
    """{label: f(xq, wq, xs, ws, bias, stride, pad, out_dtype, wp) -> out}: the
    first version as its wrapper drove it (unpacked weights; ``wp`` unused),
    today's source through ``kernels._gemm_s8`` (the planner, the packed
    weights ``wp``)."""
    from mnc_tpu_torch.kernels import _gemm_s8

    def make_parent(fn):
        def call(xq, wq, xs, ws, bias, stride, pad, out_dtype, wp):
            conv = xq.dim() == 4
            n = wq.shape[0]
            if conv:
                b, h, w, c = xq.shape
                k = wq.shape[1]
                oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
                shape = (b, oh, ow, n)
            else:
                (b, c), h, w, k, oh, ow = xq.shape, 1, 1, 1, 1, 1
                shape, stride, pad = (b, n), 1, 0
            out = torch.empty(shape, dtype=out_dtype, device=xq.device)
            vec = int(k * k * c % 16 == 0 and (not conv or c % 16 == 0))
            _ok(fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), int(not conv), ws.data_ptr(),
                   None if bias is None else bias.data_ptr(), out.data_ptr(), b, h, w, c, n,
                   k, k, stride, pad, oh, ow, int(out_dtype == torch.bfloat16), int(not conv),
                   vec, _stream()), "gemm_s8")
            return out
        return call

    def make(fn):
        def call(xq, wq, xs, ws, bias, stride, pad, out_dtype, wp):
            return _gemm_s8(fn, xq, wq, xs, ws, bias, stride, pad, out_dtype, wp)
        return call

    callers = {}
    parent = _parent(args, "gemm_s8")
    if parent:
        callers["parent (mma.sync tiles)"] = make_parent(load(parent, PARENT_ABI["gemm_s8"]))
    for suffix, src, flags in _sources(args, "gemm_s8", args.gemm_s8_variant,
                                       args.gemm_s8_source):
        callers[f"wgmma, planned {suffix}".strip()] = make(
            load(src, _build.KERNEL_ABI["gemm_s8"], flags))
    return callers


def quant_act_callers(args):
    """{label: f(x, per_row) -> (q, scale)}: plain ``quant_act``; the first
    version as its wrapper drove it (a partial buffer allocated per call);
    today's source through ``kernels._quant_act`` (the plan, the scratch)."""
    from mnc_tpu_torch.kernels import _n_sms, _quant_act
    from mnc_tpu_torch.ops.quant import quant_act

    def make_parent(fn):
        def call(x, per_row):
            k = x.shape[-1] if per_row else x.numel()
            q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            scale = torch.empty((*x.shape[:-1], 1) if per_row else (), dtype=torch.float32,
                                device=x.device)
            partial = None if per_row else torch.empty(QUANT_ACT_PARTIALS, dtype=torch.float32,
                                                       device=x.device)
            _ok(fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                   None if partial is None else partial.data_ptr(), x.numel() // k, k,
                   int(per_row), int(x.dtype == torch.bfloat16), _n_sms(x.device), _stream()),
                "quant_act")
            return q, scale
        return call

    callers = {"plain quant_act": quant_act}
    parent = _parent(args, "quant_act")
    if parent:
        callers["parent (two launches)"] = make_parent(load(parent, PARENT_ABI["quant_act"]))
    fn = load(_build.CSRC / "quant_act.cu", _build.KERNEL_ABI["quant_act"])
    callers["one launch, on chip"] = lambda x, per_row: _quant_act(fn, x, per_row)
    return callers


def there_and_back(callers, run):
    """{label: [ms in the order given, ms in the reverse order]}."""
    labels = list(callers)
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(run(callers[label]))
    return times


def device_ms(fn, iters=10):
    """{CUDA kernel name: device ms per call} over ``iters`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:80]] = t / 1e3 / iters
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--only", default=",".join(KINDS),
                    help=f"comma-separated subset of {','.join(KINDS)}")
    for kind in ("roi-warp", "nms", "bwd", "paste", "block1", "gemm-s8"):
        ap.add_argument(f"--{kind}-variant", action="append", default=[])
    for kind in ("roi-warp", "bwd", "paste", "block1", "gemm-s8"):
        ap.add_argument(f"--{kind}-source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--roi-warp-plan", action="append", default=[],
                    metavar="cell_chunks=N[,band_rows=N]")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(f"device: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    report = {"device": smi}
    wrong = []

    def profiled(kind, shape, callers, call):
        if args.profile:
            for label, fn in callers.items():
                prof = device_ms(lambda: call(fn))
                cs.log(f"{kind} {shape} [{label}] device ms per kernel: {prof}")
                report.setdefault("profile", {}).setdefault(kind, {})[f"{shape} {label}"] = prof

    if "roi_warp" in only:
        report["roi_warp"] = {}
        callers = roi_warp_callers(args)
        from mnc_tpu_torch.kernels import plan_roi_warp, roi_warp_l2_bytes
        from mnc_tpu_torch.ops.roi_warp import roi_warp_plain
        out_hw, s = cs.ROI_WARP_OUT_HW, cs.ROI_WARP_SCALE
        cases = {}
        for shape, (b, n, canvas, c) in cs.ROI_WARP_SHAPES.items():
            h, w = canvas[0] // 16, canvas[1] // 16
            feat = torch.randn(b, h, w, c, generator=g, device="cuda")
            cases[shape] = (feat, torch.stack([cs.random_boxes(g, n, *canvas)
                                               for _ in range(b)]))
        cases[cs.ROI_WARP_PROPOSALS] = cs.main_path_rois()
        for shape, (feat, rois) in cases.items():
            b, h, w, c = feat.shape
            for dt, tol_scale in cs.ROI_WARP_TOLERANCES.items():
                f = feat.to(dt)
                want = roi_warp_plain(f, rois, out_hw, s).float()
                tol = tol_scale * f.float().abs().max().item()
                first = None
                for label, fn in callers.items():
                    got = fn(f, rois, out_hw, s)
                    err = (got.float() - want).abs().max().item()
                    same = "" if first is None else f", bit-equal to the first build: " \
                        f"{torch.equal(got, first)}"
                    first = got if first is None else first
                    cs.log(f"roi_warp {shape} {dt} [{label}]: max_abs_err {err:.3e} "
                           f"(tolerance {tol:.3e}){same}")
                    if not err <= tol:
                        wrong.append(f"roi_warp [{label}] ({shape}, {dt}): off by {err:.3e}")
                        cs.log(wrong[-1])
                del want, first
            f16 = feat.to(torch.bfloat16)
            ms = there_and_back(callers, lambda fn: cs.cuda_graph_ms(
                lambda: fn(f16, rois, out_hw, s)))
            l2 = roi_warp_l2_bytes(rois, out_hw, s, (h, w), c, 2,
                                   plan_roi_warp(b, rois.shape[1], c, f16.dtype, out_hw, (h, w)))
            bms, by = cs.bound_ms(cs.nbytes(f16, rois) + rois.shape[1] * b * out_hw[0]
                                  * out_hw[1] * c * 2, 8.0 * b * rois.shape[1] * out_hw[0]
                                  * out_hw[1] * c)
            for label in callers:
                cs.log(f"roi_warp {shape} bf16 [{label}]: ms {ms[label]}")
            cs.log(f"roi_warp {shape} bf16: bound {bms:.4f} ms ({by}); L2 tap bytes {l2}")
            report["roi_warp"][shape] = {"ms": ms, "bound_ms": bms, "l2_tap_bytes": l2}
            profiled("roi_warp", shape, callers, lambda fn: fn(f16, rois, out_hw, s))
            del f16
        del cases
        torch.cuda.empty_cache()

    if "nms" in only:
        report["nms"] = {}
        callers = nms_callers(args)
        from mnc_tpu_torch.ops.nms import nms_keep_plain
        for shape, (p, k, thresh, top_n, trailing) in cs.NMS_SHAPES.items():
            boxes, valid, _ = cs._nms_case(g, p, k, cluster=max(k // 20, 4), invalid_frac=0.2,
                                           trailing=trailing)
            want = nms_keep_plain(boxes, valid, thresh, top_n)
            for label, fn in callers.items():
                got = fn(boxes, valid, thresh, top_n)
                if not torch.equal(got, want):
                    wrong.append(f"nms [{label}] ({shape}): {int((got != want).sum())} keeps "
                                 f"differ from the plain version")
                    cs.log(wrong[-1])
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(
                lambda: fn(boxes, valid, thresh, top_n)))
            for label in callers:
                cs.log(f"nms {shape} P={p} K={k} top_n={top_n} [{label}]: ms {ms[label]}")
            report["nms"][shape] = ms

    if "roi_warp_bwd" in only:
        report["roi_warp_bwd"] = {}
        callers = bwd_callers(args)
        from mnc_tpu_torch.ops.roi_warp import roi_warp_plain
        b, n, (h, w), out_hw, s = 2, 128, (40, 64), (14, 14), 1.0 / 16
        for c, (set_label, rois) in [(c, item) for c in (512, 1024)
                                     for item in cs._bwd_box_sets(g, b, n).items()]:
            set_label = f"C={c} {set_label}"
            feat = torch.randn(b, h, w, c, generator=g, device="cuda")
            gout = torch.randn(b, n, *out_hw, c, generator=g, device="cuda")
            f16, go16 = feat.to(torch.bfloat16), gout.to(torch.bfloat16)
            fp, rp = feat.clone().requires_grad_(), rois.clone().requires_grad_()
            wf, wr = torch.autograd.grad(roi_warp_plain(fp, rp, out_hw, s), (fp, rp), gout)
            for label, fn in callers.items():
                gf, gr = fn(gout, feat, rois, s)
                ef, er = (gf - wf).abs().max().item(), (gr - wr).abs().max().item()
                if ef > 1e-5 * wf.abs().max().item() or er > 1e-4 * wr.abs().max().item():
                    wrong.append(f"roi_warp_bwd [{label}] ({set_label}): f32 gradients off "
                                 f"by {ef:.3e} (dF), {er:.3e} (d rois)")
                    cs.log(wrong[-1])
                again = fn(gout, feat, rois, s)
                cs.log(f"roi_warp_bwd [{set_label}] [{label}]: two f32 calls bit-equal: dF "
                       f"{torch.equal(again[0], gf)}, d rois {torch.equal(again[1], gr)}")
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(go16, f16, rois, s)))
            for label in callers:
                cs.log(f"roi_warp_bwd bf16 [{set_label}] [{label}]: ms {ms[label]}")
            report["roi_warp_bwd"][set_label] = ms
            profiled("roi_warp_bwd", set_label, callers,
                     lambda fn: fn(go16, f16, rois, s))

    if "paste" in only:
        report["paste"] = {}
        callers = paste_callers(args)
        (h, w), thresh = cs.CANVAS, 0.4
        edge = cs._paste_inputs(g, cs._paste_edge_boxes(g, 97, 203), 97, 203)[:3]
        for label, fn in callers.items():
            for t in (thresh, -0.1):
                try:
                    cs._paste_agrees(f"[{label}] edge boxes", fn(*edge, t), *edge, t)
                except AssertionError as exc:
                    wrong.append(str(exc))
        for shape, n in cs.PASTE_SHAPES.items():
            ins = cs._paste_inputs(g, cs.random_boxes(g, n, h, w, lo=20.0, hi=500.0), h, w)[:3]
            for label, fn in callers.items():
                try:
                    cs._paste_agrees(f"[{label}] {shape}", fn(*ins, thresh), *ins, thresh)
                except AssertionError as exc:
                    wrong.append(str(exc))
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(*ins, thresh)))
            for label in callers:
                cs.log(f"paste {shape} N={n} [{label}]: ms {ms[label]}")
            report["paste"][shape] = ms
            profiled("paste", shape, callers, lambda fn: fn(*ins, thresh))

    if "block1" in only:
        report["block1"] = {}
        callers = block1_callers(args)
        from mnc_tpu_torch.ops.block1 import block1_plain, block1_tolerance, conv_relu_plain
        w1 = torch.randn(64, 3, 3, 3, generator=g, device="cuda") * 0.1
        b1 = torch.randn(64, generator=g, device="cuda")
        w2 = torch.randn(64, 64, 3, 3, generator=g, device="cuda") * 0.05
        b2 = torch.randn(64, generator=g, device="cuda")
        for shape in ((3, 40, 50, 3), (2, *cs.CANVAS, 3), (4, *cs.CANVAS, 3)):
            x = torch.randn(shape, generator=g, device="cuda") * 50
            want = block1_plain(x, w1, b1, w2, b2).float()
            o1_max = conv_relu_plain(x.to(torch.bfloat16).permute(0, 3, 1, 2), w1,
                                     b1).float().max().item()
            tol = block1_tolerance(want, o1_max, w2, b2)
            for label, fn in callers.items():
                got = fn(x, w1, b1, w2, b2).float()
                exact = (got == want).float().mean().item()
                if not ((got - want).abs() <= tol).all() or exact < 0.999:
                    wrong.append(f"block1 [{label}] {shape}: {exact:.6f} bit-identical, "
                                 f"max err {(got - want).abs().max().item():.3e}")
                    cs.log(wrong[-1])
            del want, tol
            if shape[1] < cs.CANVAS[0]:  # the ragged shape is only held, not timed
                continue
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(x, w1, b1, w2, b2),
                                                               iters=10))
            for label in callers:
                cs.log(f"block1 B={shape[0]} [{label}]: ms {ms[label]}")
            report["block1"][f"B={shape[0]}"] = ms
            profiled("block1", f"B={shape[0]}", callers, lambda fn: fn(x, w1, b1, w2, b2))

    if "gemm_s8" in only:
        report["gemm_s8"] = {}
        callers = gemm_s8_callers(args)
        from mnc_tpu_torch.kernels import pack_gemm_s8_weight
        from mnc_tpu_torch.ops.quant import gemm_s8_plain
        for shape, (kind, xshape, cout, k, stride, pad, bias, dtype) in \
                cs.GEMM_S8_SHAPES.items():
            _, _, xq, xs, wq, ws, b = cs._gemm_s8_inputs(g, kind, xshape, cout, k, bias, dtype)
            call_args = (xq, wq, xs, ws, b, stride, pad, dtype, pack_gemm_s8_weight(wq))
            want = gemm_s8_plain(*call_args[:-1])
            for label, fn in callers.items():
                if not torch.equal(fn(*call_args), want):
                    wrong.append(f"gemm_s8 [{label}] ({shape}): differs from the plain version")
                    cs.log(wrong[-1])
            del want
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(*call_args),
                                                               iters=10))
            for label in callers:
                cs.log(f"gemm_s8 {shape} [{label}]: ms {ms[label]}")
            report["gemm_s8"][shape] = ms
            profiled("gemm_s8", shape, callers, lambda fn: fn(*call_args))
            del call_args, xq, wq

    if "quant_act" in only:
        report["quant_act"] = {}
        callers = quant_act_callers(args)
        from mnc_tpu_torch.ops.quant import quant_act
        for (xshape, per_row), layer in sorted(cs.int8_layer_inputs().items(),
                                               key=lambda kv: -int(np.prod(kv[0][0]))):
            shape = f"{layer} {xshape} per {'row' if per_row else 'tensor'}"
            x = (torch.randn(xshape, generator=g, device="cuda") * 3).to(torch.bfloat16)
            wq, ws = quant_act(x, per_row)
            for label, fn in callers.items():
                gq, gs = fn(x, per_row)
                if not (torch.equal(gq, wq) and torch.equal(gs, ws)):
                    wrong.append(f"quant_act [{label}] ({shape}): differs from quant_act")
                    cs.log(wrong[-1])
                del gq, gs
            del wq, ws
            ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(x, per_row),
                                                               iters=10))
            for label in callers:
                cs.log(f"quant_act {shape} bf16 [{label}]: ms {ms[label]}")
            report["quant_act"][shape] = ms
            profiled("quant_act", shape, callers, lambda fn: fn(x, per_row))
            del x
            torch.cuda.empty_cache()

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    if wrong:
        raise AssertionError("; ".join(wrong))
    return 0


if __name__ == "__main__":
    sys.exit(main())
