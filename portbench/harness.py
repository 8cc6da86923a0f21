"""One run of one cell: the system under test built from the seed, warmed
up, driven by a closed loop for a window, traced on request, and checked
against the reference once the window has closed.

The entry that the window drives is the port's batched serving call,
``MNCPipeline.detect_canvas_batch_packed`` (``_run_batch``: ``MNC.apply_batch``,
``vote_candidates``, ``postprocess_detections``, ``pack_bits``).  A request
is timed from the copy of its uint8 canvases out of pinned host memory to
the moment its boxes, scores, classes, validity and bit-packed canvas masks
are in pinned host memory.

Spans come from this file, not from the program: forward hooks on the
port's ``trunk``, ``rpn_head``, ``mask_head`` and ``classify_head`` record a
CUDA event at each boundary in a traced run, and in every run keep (by
reference, without a copy) what the sampled requests produced, for the
check.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import sys
import time
from pathlib import Path

import torch

from portbench import check, generator, stats, weights
from portbench.metrics import reader
from portbench.peaks import peaks_for

ROOT = Path(__file__).resolve().parent
OUT_KEYS = ("boxes", "scores", "classes", "valid", "canvas_masks")
FORBIDDEN = ("jax", "jaxlib", "flax", "mnc_tpu")
E2E = {
    "images_per_s": lambda w: stats.rate(w.images, w.start, w.end),
    "request_p95_ms": lambda w: 1e3 * stats.percentile(w.latencies, 95),
    "setup_s": lambda w: w.setup_s,
}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def manifest(path: Path | None = None) -> dict:
    return json.loads((path or ROOT.parent / "BENCHMARK.json").read_text())


def resolve(cell: str, bench: dict) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT.parent / conf["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{work['traffic']}.json").read_text())
    return work, config, traffic


def cell_metrics(cell: str, bench: dict, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def build_system(net: dict, post: dict, state: dict, device):
    """The port's serving pipeline for a configuration, its weights loaded
    through ``load_state_dict`` (outside inference mode, as a server builds
    it: int8 weights are then quantized once per weight version)."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(
        canvas=tuple(net["canvas"]), feat_stride=net["feat_stride"],
        anchor_scales=tuple(net["anchor_scales"]), anchor_ratios=tuple(net["anchor_ratios"]),
        num_classes=net["num_classes"], mask_size=net["mask_size"], warp_hw=net["warp_hw"],
        pooled_hw=net["pooled_hw"], n_stages=net["n_stages"], trunk=net["trunk"],
        compute_dtype=getattr(torch, net["compute_dtype"]), fc_dim=net["fc_dim"],
        mask_fc_dim=net["mask_fc_dim"], roi_conv5=net["roi_conv5"],
        resnet_stride_in_3x3=net["stride_in_3x3"], pre_nms_top_n=net["pre_nms_top_n"],
        post_nms_top_n=net["post_nms_top_n"], rpn_nms_thresh=net["rpn_nms_thresh"],
        rpn_min_size=net["rpn_min_size"], bbox_means=tuple(net["bbox_means"]),
        bbox_stds=tuple(net["bbox_stds"]),
        suppress_untrainable_anchors=net["suppress_untrainable_anchors"],
        fused_block1=net["fused_block1"], int8_inference=net["int8"])
    if (arch.pre_nms_top_n, arch.post_nms_top_n) != (net["pre_nms_top_n"], net["post_nms_top_n"]):
        raise ValueError("the proposal budget does not fit the canvas's anchors")
    with torch.inference_mode(False):
        model = MNC(arch, device=device, seed=None)
        model.load_state_dict(state, strict=True)
    keys = ("nms_thresh", "dets_per_class", "max_per_image", "use_mask_merge",
            "mask_merge_iou", "vote_top_k", "score_thresh", "binarize_thresh", "vote_impl")
    return MNCPipeline(model, PostCfg(**{k: post[k] for k in keys}))


class Recorder:
    """Module hooks on the program: CUDA events at the layer boundaries
    (``events`` a list while tracing) and, for a captured request, its RPN
    and head outputs and the cascade's outputs, kept by reference."""

    def __init__(self, pipe, trace: bool):
        model = pipe.model
        self.capture: dict | None = None
        self.events: list | None = [] if trace else None
        self._handles = []
        for name, mod in (("trunk", model.trunk), ("rpn", model.rpn_head),
                          ("mask", model.mask_head), ("cls", model.classify_head)):
            self._handles.append(mod.register_forward_pre_hook(
                lambda *_, n=name: self.mark(f"{n}_pre")))
            self._handles.append(mod.register_forward_hook(
                lambda _m, _a, out, n=name: self._post(n, out)))
        apply_batch = model.apply_batch

        def recorded(*args, **kwargs):
            out = apply_batch(*args, **kwargs)
            if self.capture is not None:
                self.capture["net"] = out
            return out
        model.apply_batch = recorded

    def mark(self, name: str) -> None:
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((name, ev))

    def _post(self, name: str, out) -> None:
        self.mark(f"{name}_post")
        if self.capture is not None:
            if name == "rpn":
                self.capture["rpn"] = out
            elif name in ("mask", "cls"):
                self.capture.setdefault(name, []).append(out)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def spans_ms(requests: list) -> dict:
    """Per-request span milliseconds from each request's [(name, event)]."""
    out = {"trunk": [], "heads": [], "postprocess": []}
    for evs in requests:
        first = {}
        for name, ev in evs:
            first.setdefault(name, ev)
        pairs = zip([ev for n, ev in evs if n == "mask_pre"],
                    [ev for n, ev in evs if n == "cls_post"])
        out["trunk"].append(first["trunk_pre"].elapsed_time(first["trunk_post"]))
        out["heads"].append(sum(a.elapsed_time(b) for a, b in pairs))
        last_cls = [ev for n, ev in evs if n == "cls_post"][-1]
        out["postprocess"].append(last_cls.elapsed_time(evs[-1][1]))
    return out


@dataclasses.dataclass
class Window:
    start: float
    end: float
    latencies: list
    images: int
    setup_s: float


@dataclasses.dataclass
class LayerContext:
    net: dict
    post: dict
    canvases: int
    peaks: dict
    trace: object
    n_traced: int
    spans: dict

    def span_ms(self, name: str):
        vals = self.spans.get(name) or []
        return sum(vals) / len(vals) if vals else None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        process_start: float | None = None, bench: dict | None = None,
        adjust=None, tamper=None, limits: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    ``adjust(config, traffic)`` edits the configuration and the mix before
    anything is built (the control's int8 path; the CPU tests' small sizes),
    ``tamper(pipe)`` plants a fault in the timed path (the fault tests), and
    ``limits`` overrides the cell's file of limits."""
    t_proc = time.time() if process_start is None else process_start
    bench = bench or manifest()
    work, config, traffic = resolve(cell, bench)
    if adjust is not None:
        adjust(config, traffic)
    if (traffic["loop"], traffic["clients"], traffic["in_flight"]) != ("closed", 1, 1):
        raise ValueError(f"{traffic['name']}: the harness drives one closed-loop client with "
                         "one request in flight")
    net, post = config["net"], config["post"]
    dev = torch.device(device)

    def stamp(what: str) -> None:
        print(f"set-up: {what} at {time.time() - t_proc:.3f} s", file=sys.stderr)
    b, pool_n = traffic["canvases_per_request"], traffic["pool_requests"]

    stamp("started")
    state = weights.draw(net, seed, dev, getattr(torch, net["compute_dtype"]))
    _sync(dev)
    stamp("weights drawn")
    pipe = build_system(net, post, state, dev)
    if tamper is not None:
        tamper(pipe)
    _sync(dev)
    stamp("model built")
    pool = generator.make_pool(traffic, net["canvas"], seed, dev)
    stamp("pool made")
    rec = Recorder(pipe, trace and dev.type == "cuda")
    sample = random.Random(seed).sample(range(pool_n), min(traffic["sample_requests"], pool_n))
    host: dict = {}
    captures: dict = {}

    def serve(slot: int):
        x = pool.canvases[slot].to(dev, non_blocking=True)
        info = pool.im_info[slot].to(dev, non_blocking=True)
        out = pipe.detect_canvas_batch_packed(x, info)
        rec.mark("end")
        if not host:
            for k in OUT_KEYS:
                host[k] = torch.empty(out[k].shape, dtype=out[k].dtype,
                                      pin_memory=dev.type == "cuda")
        for k in OUT_KEYS:
            host[k].copy_(out[k], non_blocking=True)
        _sync(dev)
        return out

    def serve_captured(slot: int):
        """A sampled request keeps what it produced, in place of what the
        slot produced before (freed first, so the allocator reuses it)."""
        captures.pop(slot, None)
        rec.capture = {}
        out = serve(slot)
        rec.capture["out"] = out
        captures[slot], rec.capture = rec.capture, None
        return out

    # the warm-up serves the sampled requests first: the memory that their
    # kept outputs hold is then part of the steady state before the window
    warm = sample + [s for s in range(pool_n) if s not in sample]
    for i in range(max(traffic["warmup_requests"], len(sample))):
        slot = warm[i % pool_n]
        serve_captured(slot) if slot in sample else serve(slot)
        if i == 0:
            stamp("first request served")
    stamp("warm-up requests served")
    profilers = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        device_only = [ProfilerActivity.CUDA]
        with_host = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for acts in (device_only, with_host):  # the profiler's own warm-up, discarded
            with profile(activities=acts):
                serve(warm[-1])
        profilers = [profile(activities=device_only), profile(activities=with_host)]
    _sync(dev)
    setup_s = time.time() - t_proc
    stamp("set-up done")

    latencies, per_request_events = [], []
    plan = []  # (profiler, first request, requests): the device alone, then the host too
    if profilers:
        first = traffic["traced_requests"]
        plan = [(profilers[0], 0, first), (profilers[1], first, traffic["host_traced_requests"])]
    spans = []  # (profiler, start ns, end ns, requests)
    window_slots = set()
    start = time.perf_counter()
    i = 0
    while True:
        slot = i % pool_n
        if plan and i == plan[0][1]:
            _sync(dev)
            plan[0][0].start()
            t_ns = time.time_ns()
        if rec.events is not None:
            rec.events = []
        t0 = time.perf_counter()
        if slot in sample:
            serve_captured(slot)
            window_slots.add(slot)
        else:
            serve(slot)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if rec.events is not None:
            per_request_events.append(rec.events)
        i += 1
        if plan and i > plan[0][1] and (i == plan[0][1] + plan[0][2] or t1 - start >= seconds):
            _sync(dev)
            prof, first, _ = plan.pop(0)
            spans.append((prof, t_ns, time.time_ns(), i - first))
            prof.stop()
        if t1 - start >= seconds:
            break
    end = t1
    dets = host["valid"].sum(-1).tolist()
    window = Window(start, end, latencies, i * b, setup_s)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if not trace:
        for m in cell_metrics(cell, bench, False):
            metrics[m["name"]] = {"value": E2E[m["name"]](window), "unit": m["unit"]}
    else:
        tr, n_traced = None, 0
        if spans:
            from portbench.trace import from_profiler

            prof, t_start, t_end, n_traced = spans[0]
            tr = from_profiler(prof, t_start, t_end)
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.device_ops()}
            if len(spans) > 1:
                breakdown["idle_gaps"] = from_profiler(*spans[1][:3]).idle_gaps()
        _sync(dev)
        ctx = LayerContext(net, post, b,
                           peaks_for(device_info["kind"]) if dev.type == "cuda" else {},
                           tr, n_traced,
                           spans_ms(per_request_events) if per_request_events else {})
        for m in cell_metrics(cell, bench, True):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    rec.remove()

    # the program's state goes before the reference runs; what it produced
    # for the sampled requests stays
    del pipe, rec, host
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    r = check.Reference(state, net, post, dev)
    del state
    parts = []
    for slot in sorted(window_slots):
        parts.append(check.compare_request(r, pool.canvases[slot], pool.im_info[slot],
                                           captures[slot]))
        captures[slot] = None
    numbers = check.combine(parts)
    limits = limits or json.loads((ROOT / "limits" / f"{cell}.json").read_text())["limits"]
    det_counts = [p["dets"] for p in parts]
    print(f"detections per canvas (last request): {dets}; detections per compared "
          f"request: {det_counts}", file=sys.stderr)
    correct = check.verdict(numbers, limits) and bool(det_counts) and min(det_counts) > 0
    result = {"correct": correct, "attempted": i, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    for k in check.NUMBERS:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r}) over {len(parts)} requests",
              file=sys.stderr)
    return result


def json_line(result: dict) -> str:
    """The result as one JSON line; an infinite number is written as a string."""
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, list):
            return [clean(v) for v in x]
        return x
    return json.dumps(clean(result))
