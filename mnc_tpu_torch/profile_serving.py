"""Where the time of one serving request goes, on the GPU.

    python3 -m mnc_tpu_torch.profile_serving [--batch 4] [--iters 5] [--fused-block1] \
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...]

Drives the full-width 5-stage serving path of ``MNCArch.from_cfg()`` on
the default cfg, or on the one that ``--cfg`` and ``--set`` make (the
default is the VGG-16 configuration of ``chip_smoke.py``: 640×1024 canvas,
pre-NMS 6000, post-NMS 304, bf16; ``--cfg
experiments/cfgs/mnc_coco_resnet101.yml --set NET.ROI_CONV5 True`` is the
ResNet-101 COCO one), with seeded random init (``--fused-block1`` runs VGG
block 1 through kernel D), and prints, for one request of ``--batch``
canvases:

- per-stage stream times from CUDA events around each stage (trunk, RPN +
  proposals, first head pass, bridge + second head pass, post-processing;
  a stage's time includes any gap in which the device waited for the host),
  averaged over ``--iters`` requests, and the median wall time of those
  requests (host clock, ending in a synchronize);
- the device's busy time in one more request, traced by ``torch.profiler``
  (the sum of kernel times on the one stream), and the idle share of the
  median wall time that leaves;
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
from mnc_tpu_torch.models.mnc import MNC, MNCArch, propose_rois, stage_bridge
from mnc_tpu_torch.pipeline.inference import PostCfg, postprocess_detections
from mnc_tpu_torch.pipeline.inference import vote_candidates


def _stages(model, post, images, infos):
    """One request as a list of (stage name, thunk) run in order."""
    a = model.arch
    st = {}

    def trunk():
        st["feat"] = model.features(images)

    def propose():
        cls, box = model.rpn(st["feat"])
        st["rois"], st["valid"], _ = propose_rois(cls, box, infos, model.anchors, a)

    def heads1():
        st["m1"], st["p1"], st["b1"] = model._heads(st["feat"], st["rois"])

    def heads2():
        st["rois2"] = stage_bridge(st["rois"], st["p1"], st["b1"], infos, a)
        st["m2"], st["p2"], _ = model._heads(st["feat"], st["rois2"])

    def postprocess():
        net = {"rois": st["rois2"], "roi_valid": st["valid"],
               "cls_prob": 0.5 * (st["p1"] + st["p2"]), "mask_logits": st["m2"],
               "stage3_rois": st["rois"], "stage3_cls_prob": st["p1"],
               "stage3_mask_logits": st["m1"]}
        st["out"] = postprocess_detections(*vote_candidates(net, post, 5, axis=1), post,
                                           a.canvas)

    return [("trunk", trunk), ("rpn+proposals", propose), ("heads pass 1", heads1),
            ("bridge+heads pass 2", heads2), ("postprocess", postprocess)]


def _event_ms(fn, iters=5) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_layer_split(model, stages) -> None:
    """Times the activation quantization (kernel F) and the kernel E launch
    of every int8 layer on the inputs one request hands it (the first call
    of each layer: the first head pass; the second pass has the same
    shapes)."""
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
        for _, fn in stages:
            fn()
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

    for _, fn in _stages(model, post, images, infos):  # warm-up
        fn()
    totals: dict = {}
    walls = []
    for _ in range(args.iters):
        stages = _stages(model, post, images, infos)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        for (name, fn), ev in zip(stages, events[1:]):
            fn()
            ev.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for (name, _), e0, e1 in zip(stages, events[:-1], events[1:]):
            totals[name] = totals.get(name, 0.0) + e0.elapsed_time(e1) / args.iters
    total = sum(totals.values())
    print(f"stage stream times per request of {args.batch} canvases "
          f"(mean of {args.iters}, CUDA events; fused_block1={args.fused_block1}):")
    for name, ms in totals.items():
        print(f"  {name:22s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    print(f"  {'total':22s} {total:9.3f} ms")
    wall_ms = sorted(walls)[len(walls) // 2]
    print(f"wall time per request: median {wall_ms:.3f} ms of "
          + ", ".join(f"{w:.3f}" for w in walls))
    torch.cuda.reset_peak_memory_stats()
    for _, fn in _stages(model, post, images, infos):
        fn()
    torch.cuda.synchronize()
    print(f"peak device memory of a request {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in _stages(model, post, images, infos):
            fn()
        torch.cuda.synchronize()
    # device-side rows only (the aten:: rows repeat their kernels' time)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"device busy {busy_ms:.3f} ms per request (traced); idle share of the "
          f"median wall time {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("top kernels by device time in the profiled request:")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if arch.int8_inference:
        int8_layer_split(model, _stages(model, post, images, infos))


if __name__ == "__main__":
    main()
