"""Time kernels B (NMS) and A′ (RoI-warp backward) against earlier or
differently tuned builds of themselves, on one GPU, inside one process.

    python3 -m mnc_tpu_torch.compare_kernels [--parent-csrc DIR]
        [--nms-variant=-DMNC_NMS_CLUSTER=8] [--bwd-variant=-DMNC_RWB_THREADS=1024]
        [--bwd-source LABEL=PATH] [--out FILE.json]

Run it from the repository's root (it borrows ``chip_smoke.py``'s inputs and
timer).  Two runs on two cards, or at two times, cannot be compared, so every
build is timed in one call, in the order given and then in reverse (parent,
change, ..., change, parent), each after its outputs were held against the
plain PyTorch version.

``--parent-csrc DIR`` names a directory holding the first port's ``nms.cu``
and ``roi_warp_bwd.cu`` (``git show <commit>:mnc_tpu_torch/csrc/nms.cu``):
the bitmask-then-scan NMS, which takes a (P, K, K/64) scratch, and the
scatter backward, which writes one partial of d rois per output row.  They
are driven exactly as their wrappers drove them (scratch allocated per call,
partials summed by ``Tensor.sum``).  Each ``--nms-variant`` /
``--bwd-variant`` (repeatable) builds the current source with extra ``nvcc``
flags (the macros at the head of the two sources), which is how the cluster
size, the block sizes and the channel slab were settled; ``--bwd-source``
times another source file that has today's interface.  A build whose outputs
are wrong is reported, timed all the same, and fails the run at its end.
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

import torch

from mnc_tpu_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_PORT_ABI = {  # the C interfaces of the first port's two kernels
    "nms": ("nms.cu", "mnc_nms_keep", [_P, _P, _P, _P, _I, _I, _F, _I, _P]),
    "roi_warp_bwd": _build.KERNEL_ABI["roi_warp_bwd"],
}


def load(source: Path, abi, flags=()):
    """Compile ``source`` with the port's flags plus ``flags``; the C function."""
    nvcc = _build.nvcc_path()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libcompare-{source.stem}-{tag}.so"
    if not lib.exists():
        subprocess.run([nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(source)],
                       check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), abi[1])
    fn.argtypes, fn.restype = abi[2], ctypes.c_int
    return fn


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def nms_callers(args):
    """{label: f(boxes, valid, thresh, top_n) -> keep}."""
    callers = {}
    if args.parent_csrc:
        first = load(Path(args.parent_csrc) / "nms.cu", FIRST_PORT_ABI["nms"])

        def parent(boxes, valid, thresh, top_n, fn=first):
            p, k, _ = boxes.shape
            mask = torch.empty((p, k, -(-k // 64)), dtype=torch.int64, device=boxes.device)
            keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
            _ok(fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), p, k,
                   thresh, top_n, _stream()), "first port's nms")
            return keep

        callers["first port (bitmask + scan per keep)"] = parent
    for flags in [""] + args.nms_variant:
        fn = load(_build.CSRC / "nms.cu", _build.KERNEL_ABI["nms"], shlex.split(flags))

        def current(boxes, valid, thresh, top_n, fn=fn):
            p, k, _ = boxes.shape
            keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
            _ok(fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), p, k, thresh, top_n,
                   _stream()), "nms")
            return keep

        callers[f"chunked scan {flags}".strip()] = current
    return callers


def bwd_callers(args):
    """{label: f(grad, feat, rois, scale) -> (dF f32, d rois)}."""
    callers = {}

    def make(fn, partials):
        def call(go, f, rois, scale):
            b, h, w, c = f.shape
            n, (ph, pw) = rois.shape[1], go.shape[2:4]
            dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=f.device)
            out = torch.empty((b, n, ph, 4) if partials else (b, n, 4), dtype=torch.float32,
                              device=f.device)
            _ok(fn(go.data_ptr(), f.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
                   out.data_ptr(), b, h, w, c, n, ph, pw, scale,
                   0 if f.dtype == torch.float32 else 1, _stream()), "roi_warp_bwd")
            return dfeat.to(f.dtype), (out.sum(dim=2) if partials else out)
        return call

    if args.parent_csrc:
        callers["first port (4 atomics per value)"] = make(
            load(Path(args.parent_csrc) / "roi_warp_bwd.cu", FIRST_PORT_ABI["roi_warp_bwd"]),
            partials=True)
    for spec in args.bwd_source:  # another source with today's interface
        label, _, path = spec.partition("=")
        callers[label] = make(load(Path(path), _build.KERNEL_ABI["roi_warp_bwd"]),
                              partials=False)
    for flags in [""] + args.bwd_variant:
        callers[f"register sums {flags}".strip()] = make(
            load(_build.CSRC / "roi_warp_bwd.cu", _build.KERNEL_ABI["roi_warp_bwd"],
                 shlex.split(flags)), partials=False)
    return callers


def there_and_back(callers, run):
    """{label: [ms in the order given, ms in the reverse order]}."""
    labels = list(callers)
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(run(callers[label]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--nms-variant", action="append", default=[])
    ap.add_argument("--bwd-variant", action="append", default=[])
    ap.add_argument("--bwd-source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from mnc_tpu_torch.ops.nms import nms_keep_plain
    from mnc_tpu_torch.ops.roi_warp import roi_warp_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(f"device: {smi}")
    g = torch.Generator(device="cuda").manual_seed(0)
    report = {"device": smi, "nms": {}, "roi_warp_bwd": {}}
    wrong = []

    callers = nms_callers(args)
    for shape, (p, k, thresh, top_n, trailing) in cs.NMS_SHAPES.items():
        boxes, valid, _ = cs._nms_case(g, p, k, cluster=max(k // 20, 4), invalid_frac=0.2,
                                       trailing=trailing)
        dup = torch.tensor([10.0, 10.0, 50.0, 50.0], device="cuda").expand(p, k, 4).contiguous()
        ones = torch.ones(p, k, dtype=torch.bool, device="cuda")
        want = nms_keep_plain(boxes, valid, thresh, top_n)
        for label, fn in callers.items():
            got = fn(boxes, valid, thresh, top_n)
            if not torch.equal(got, want):
                wrong.append(f"nms [{label}] ({shape}): {int((got != want).sum())} keeps "
                             f"differ from the plain version, first at "
                             f"{(got != want).nonzero()[0].tolist()}")
                cs.log(wrong[-1])
        ms = there_and_back(callers, lambda fn: cs.cuda_ms(
            lambda: fn(boxes, valid, thresh, top_n)))
        # identical boxes: every chunk walked, one keep (the scan's bare step)
        walk = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(dup, ones, 0.5, 0)))
        for label in callers:
            cs.log(f"nms {shape} P={p} K={k} top_n={top_n} [{label}]: ms {ms[label]}; "
                   f"identical boxes, whole scan: ms {walk[label]}")
        report["nms"][shape] = {"ms": ms, "identical_boxes_ms": walk}

    callers = bwd_callers(args)
    b, n, (h, w, c), out_hw, s = 2, 128, (40, 64, 512), (14, 14), 1.0 / 16
    feat = torch.randn(b, h, w, c, generator=g, device="cuda")
    gout = torch.randn(b, n, *out_hw, c, generator=g, device="cuda")
    f16, go16 = feat.to(torch.bfloat16), gout.to(torch.bfloat16)
    for set_label, rois in cs._bwd_box_sets(g, b, n).items():
        fp, rp = feat.clone().requires_grad_(), rois.clone().requires_grad_()
        wf, wr = torch.autograd.grad(roi_warp_plain(fp, rp, out_hw, s), (fp, rp), gout)
        for label, fn in callers.items():
            gf, gr = fn(gout, feat, rois, s)
            ef, er = (gf - wf).abs().max().item(), (gr - wr).abs().max().item()
            if ef > 1e-5 * wf.abs().max().item() or er > 1e-4 * wr.abs().max().item():
                wrong.append(f"roi_warp_bwd [{label}] ({set_label}): f32 gradients off by "
                             f"{ef:.3e} (dF), {er:.3e} (d rois)")
                cs.log(wrong[-1])
        ms = there_and_back(callers, lambda fn: cs.cuda_ms(lambda: fn(go16, f16, rois, s)))
        for label in callers:
            cs.log(f"roi_warp_bwd bf16 [{set_label}] [{label}]: ms {ms[label]}")
        report["roi_warp_bwd"][set_label] = ms

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
