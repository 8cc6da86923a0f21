"""Where the time of one serving request goes, on the GPU.

    python3 -m mnc_tpu_torch.profile_serving [--batch 4] [--iters 5] [--fused-block1] \
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...]

Drives the full-width 5-stage serving path of ``MNCArch.from_cfg()`` on
the default cfg, or on the one that ``--cfg`` and ``--set`` make (the
default is the VGG-16 configuration of ``chip_smoke.py``: 640×1024 canvas,
pre-NMS 6000, post-NMS 304, bf16; ``--cfg
experiments/cfgs/mnc_coco_resnet101.yml --set NET.ROI_CONV5 True`` is the
ResNet-101 COCO one), with seeded random init (``--fused-block1`` runs VGG
block 1 through kernel D), and drives ``MNCPipeline.detect_canvas_batch_packed``
(``_run_batch``, the benchmark's request) with the program's spans on
(``mnc_tpu_torch/utils/spans.py``).  It prints, for one request of
``--batch`` canvases:

- the set-up spans of the pipeline (``mnc.build``, ``mnc.first_request``);
- each span's host milliseconds a request and, for the spans timed by CUDA
  events (``mnc.propose``, ``mnc.pack``), its device milliseconds, averaged
  over ``--iters`` requests, and the median wall time of those requests
  (host clock, ending in a synchronize);
- the device's busy time in one more request, traced by ``torch.profiler``
  (the sum of kernel times on the one stream), the idle share of the
  median wall time that leaves, and the device time of the kernels
  launched inside each span of that request;
- the kernels that take the most device time, by name;
- under ``TEST.INT8`` (``--set TEST.INT8 True``), each int8 layer of the
  request on its own: the device time of its activation quantization
  (kernel F) and of its kernel E launch (with the packed weights the layer
  caches), on the inputs the request gave it (CUDA events); a layer whose
  input another int8 layer quantized (a ResNet block's ``proj``) shows F as
  shared and adds none to the total.

It needs a GPU and exits with an error without one.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from mnc_tpu_torch.config import cfg_from_file, cfg_from_list
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg
from mnc_tpu_torch.utils import spans


def _event_ms(fn, iters=5) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_layer_split(model, request) -> None:
    """Times the activation quantization (kernel F) and the kernel E launch
    of every int8 layer on the inputs that one ``request()`` hands it (the
    first call of each layer: the first head pass; the second pass has the
    same shapes)."""
    from mnc_tpu_torch.kernels import gemm_s8_cuda, quant_act_cuda
    from mnc_tpu_torch.ops.quant import QUANT_LAYERS, ConvInt8, quantized_weight

    seen: dict = {}

    def keep_first(mod, args, kwargs, name):
        if name not in seen:  # a layer handed its input quantized shares that F launch
            shared = kwargs.get("quantized")
            seen[name] = (mod, args[0].clone(), None if shared is None else shared[0])

    hooks = [m.register_forward_pre_hook(
             lambda mod, args, kwargs, name=name: keep_first(mod, args, kwargs, name),
             with_kwargs=True)
             for name, m in model.named_modules() if isinstance(m, QUANT_LAYERS)]
    try:
        request()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    rows, tq, te, counted = [], 0.0, 0.0, set()
    for name, (mod, x, shared) in seen.items():
        conv = isinstance(mod, ConvInt8)
        x = (x.permute(0, 2, 3, 1) if conv else x).contiguous()
        xq, xs = quant_act_cuda(x, per_row=not conv)
        wq, ws = quantized_weight(mod.weight)
        wp, _ = quantized_weight(mod.weight, packed=True)
        bias = None if mod.bias is None else mod.bias.float()
        args = (mod.stride[0], mod.padding[0]) if conv else (1, 0)
        q_ms = _event_ms(lambda: quant_act_cuda(x, per_row=not conv))
        e_ms = _event_ms(lambda: gemm_s8_cuda(xq, wq, xs, ws, bias, *args, x.dtype, wp))
        again = shared is not None and id(shared) in counted  # kept alive in seen: ids unique
        counted.add(id(shared))
        rows.append((name, tuple(x.shape), q_ms, e_ms, again))
        tq, te = tq + (0.0 if again else q_ms), te + e_ms
    n_f = sum(not r[4] for r in rows)
    print(f"int8 layers of one pass (trunk once, heads once; the request runs the heads "
          f"twice), device ms each, CUDA events: kernel F {tq:.3f} ms ({n_f} launches), "
          f"kernel E {te:.3f} ms ({len(rows)}) in all")
    for name, shape, q_ms, e_ms, again in rows:
        f = "  (shared)" if again else f"{q_ms:8.3f}"  # the input quantized for the layer before
        print(f"  {name:36s} {str(shape):24s} F {f:>10s}  E {e_ms:8.3f}")


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--fused-block1", action="store_true")
    ap.add_argument("--cfg", default=None, help="a YAML file merged into the cfg")
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None,
                    help="KEY VALUE pairs set in the cfg after --cfg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    arch = MNCArch.from_cfg(fused_block1=args.fused_block1)
    print(f"arch: {arch.trunk}, roi_conv5={arch.roi_conv5}, {arch.num_classes} classes, "
          f"pre-NMS {arch.pre_nms_top_n}, post-NMS {arch.post_nms_top_n}, {arch.compute_dtype}"
          f", int8_inference={arch.int8_inference}")
    # made outside inference mode, as a server makes it: the int8 layers
    # quantize their weights once per weight version (an inference tensor
    # has no version counter, and would be quantized on every call)
    with torch.inference_mode(False):
        model = MNC(arch, device="cuda", seed=0)
    post = PostCfg.from_cfg(dets_per_class=16)
    g = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (args.batch, *arch.canvas, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]]
                         * args.batch, device="cuda")

    pipe = MNCPipeline(model, post)

    def request():
        pipe.detect_canvas_batch_packed(images, infos)
        torch.cuda.synchronize()

    request()  # the pipeline's first request: kernels loaded, cuDNN's first calls
    for sp in spans.setup_records():
        print(f"set-up span {sp.name}: {(sp.end_ns - sp.start_ns) / 1e9:.3f} s (host)")
    spans.reset()
    spans.enable(True)
    walls = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        request()
        walls.append((time.perf_counter() - t0) * 1e3)
    by_name: dict = {}
    for sp in spans.records():
        n, host, dev = by_name.get(sp.name, (0, 0.0, None))
        ms = sp.device_ms()
        by_name[sp.name] = (n + 1, host + (sp.end_ns - sp.start_ns) / 1e6,
                            None if ms is None else (dev or 0.0) + ms)
    print(f"program spans per request of {args.batch} canvases (mean of {args.iters}; host "
          f"clock, and CUDA events where the span has them; fused_block1={args.fused_block1}):")
    for name, (n, host, dev) in by_name.items():
        dev_s = "" if dev is None else f"  device {dev / args.iters:9.3f} ms"
        print(f"  {name:14s} x{n / args.iters:<4g} host {host / args.iters:9.3f} ms{dev_s}")
    wall_ms = sorted(walls)[len(walls) // 2]
    print(f"wall time per request: median {wall_ms:.3f} ms of "
          + ", ".join(f"{w:.3f}" for w in walls))
    torch.cuda.reset_peak_memory_stats()
    request()
    print(f"peak device memory of a request {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request()  # spans on: the profile holds their ranges
    spans.enable(False)
    events = prof.key_averages()
    # device-side rows only (the aten:: rows repeat their kernels' time; the
    # spans' device-side annotation rows cover their kernels and gaps)
    rows = [e for e in events if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("mnc.")]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"device busy {busy_ms:.3f} ms per request (traced); idle share of the "
          f"median wall time {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    print("device time of the kernels launched inside each span (the traced request):")
    for e in events:
        if e.key.startswith("mnc.") and e.device_type == DeviceType.CPU:
            print(f"  {e.key:14s} x{e.count:<4d} {e.device_time_total / 1e3:9.3f} ms")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("top kernels by device time in the profiled request:")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if arch.int8_inference:
        int8_layer_split(model, request)


if __name__ == "__main__":
    main()
