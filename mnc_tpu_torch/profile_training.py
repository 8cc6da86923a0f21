"""Where the time of one training step goes, on the GPU.

    python3 -m mnc_tpu_torch.profile_training [--batch 2] [--iters 5] [--fused-block1] \
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...]

Drives the full-width 5-stage train step of ``MNCArch.from_cfg(train=True)``
on the default cfg (the VGG-16 configuration of ``chip_smoke.py``'s training
phase) or on the one that ``--cfg`` and ``--set`` make (``--cfg
experiments/cfgs/mnc_coco_resnet101.yml --set NET.ROI_CONV5 True`` is the
ResNet-101 COCO one): 640×1024 canvas, pre-NMS 12000, post-NMS 2000, 128
RoIs and 256 anchors per image, bf16 compute on f32 master parameters, the
first two trunk blocks or stages frozen, the solver of ``cfg.TRAIN`` (with
its ``CLIP_GRADIENTS``), seeded random init, synthetic shapes batches; and
prints, for one step of ``--batch`` images:

- per-stage stream times from CUDA events at the stage boundaries of
  ``mnc_loss`` (forward), then backward and the optimizer update (a stage's
  time includes any gap in which the device waited for the host), averaged
  over ``--iters`` steps, and the median wall time of those steps (host
  clock, ending in a synchronize);
- the peak device memory of a step;
- the device's busy time in one more step, traced by ``torch.profiler`` (the
  sum of kernel times on the one stream), and the idle share of the median
  wall time that leaves;
- the kernels that take the most device time, by name;
- what holding cuDNN to deterministic algorithms costs (every train step of
  the port runs under ``train.loop.deterministic_cudnn``): ``--iters`` steps
  each way, interleaved (with, without, without, with, ...), their median
  walls, and one traced step each way, its device busy time.

Every step but the comparison's "without" runs under the setting, as the
port's train steps do.  It needs a GPU and exits with an error without
one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import time

import torch

from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from mnc_tpu_torch.data.synthetic import SyntheticShapes
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.train.loop import (deterministic_cudnn, draw_step_randoms, mnc_loss,
                                      train_cfg_from_cfg)
from mnc_tpu_torch.train.optim import make_optimizer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--fused-block1", action="store_true")
    ap.add_argument("--cfg", default=None, help="a YAML file merged into the cfg")
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None,
                    help="KEY VALUE pairs set in the cfg after --cfg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    arch = dataclasses.replace(MNCArch.from_cfg(train=True), fused_block1=args.fused_block1)
    print(f"arch: {arch.trunk}, roi_conv5={arch.roi_conv5}, {arch.num_classes} classes, "
          f"pre-NMS {arch.pre_nms_top_n}, post-NMS {arch.post_nms_top_n}, "
          f"clip_gradients {cfg.TRAIN.CLIP_GRADIENTS}")
    train_cfg = train_cfg_from_cfg(cfg)
    model = MNC(arch, device="cuda", seed=0, train=True)
    opt = make_optimizer(model, base_lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
                         weight_decay=cfg.TRAIN.WEIGHT_DECAY, gamma=cfg.TRAIN.GAMMA,
                         stepsize=cfg.TRAIN.STEPSIZE, clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=6, max_gt=cfg.STATIC.MAX_GT,
                           gt_mask_size=28, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in data.batch(range(i * args.batch, (i + 1) * args.batch)).items()}
               for i in range(args.iters + 2)]

    def one_step(batch, mark=None, deterministic=True):
        draws = draw_step_randoms(gen, arch, train_cfg, args.batch, cfg.STATIC.MAX_GT)
        if mark:
            mark("draws")
        with deterministic_cudnn() if deterministic else contextlib.nullcontext():
            total, _ = mnc_loss(model, batch, draws, arch, model.anchors, train_cfg, mark)
            total.backward()
            if mark:
                mark("backward")
            opt.step()
        if mark:
            mark("optimizer")

    one_step(batches[-1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals: dict = {}
    walls = []
    for i in range(args.iters):
        events = [("start", torch.cuda.Event(enable_timing=True))]

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0][1].record()
        one_step(batches[i], mark)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for (_, e0), (name, e1) in zip(events[:-1], events[1:]):
            totals[name] = totals.get(name, 0.0) + e0.elapsed_time(e1) / args.iters
    total = sum(totals.values())
    print(f"stage stream times per step of {args.batch} images (mean of {args.iters}, "
          f"CUDA events; fused_block1={args.fused_block1}):")
    for name, ms in totals.items():
        print(f"  {name:30s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    print(f"  {'total':30s} {total:9.3f} ms")
    wall_ms = sorted(walls)[len(walls) // 2]
    print(f"wall time per step: median {wall_ms:.3f} ms of "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f"; {1e3 * args.batch / wall_ms:.2f} img/s")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(deterministic=True):
        """One traced step: the device-side rows (the aten:: rows repeat
        their kernels' time)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one_step(batches[-2], deterministic=deterministic)
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]

    rows = traced()
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    n_kernels = sum(e.count for e in rows)
    print(f"device busy {busy_ms:.3f} ms per step in {n_kernels} kernel launches (traced); "
          f"idle share of the median wall time {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("top kernels by device time in the profiled step:")
    for e in rows[:18]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")

    # the cost of deterministic cuDNN: interleaved steps with and without it
    one_step(batches[-1], deterministic=False)  # warm-up of the other algorithms
    walls_by = {True: [], False: []}
    for i in range(2 * args.iters):
        det = (i % 4) in (0, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(batches[i % args.iters], deterministic=det)
        torch.cuda.synchronize()
        walls_by[det].append((time.perf_counter() - t0) * 1e3)
    busy = {det: sum(e.self_device_time_total for e in traced(det)) / 1e3
            for det in (True, False)}
    med = {det: sorted(w)[len(w) // 2] for det, w in walls_by.items()}
    for det, name in ((True, "with"), (False, "without")):
        print(f"{name} deterministic cuDNN: wall median {med[det]:.3f} ms of "
              + ", ".join(f"{w:.3f}" for w in walls_by[det])
              + f"; device busy {busy[det]:.3f} ms (one traced step)")
    print(f"deterministic cuDNN: wall {med[True] / med[False]:.3f}x, device busy "
          f"{busy[True] / busy[False]:.3f}x the step without it")


if __name__ == "__main__":
    main()
