"""Train MNC on the synthetic shapes imdb — the port's counterpart of
``tools/train_net.py`` for ``--imdb synthetic[_<n>]``.

    python3 -m mnc_tpu_torch.tools.train_net --imdb synthetic_64 --iters 100 \\
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...] [--out DIR] \\
        [--ims-per-batch N] [--seed S] [--device cpu]

Builds the architecture with ``MNCArch.from_cfg(train=True)`` and the
synthetic overrides (the imdb's canvas and classes, small anchors), the
solver from ``cfg.TRAIN.*``, writes every step's metrics to
``<out>/train_metrics.jsonl`` and prints them every ``--print-every`` steps
(``utils.metrics.MetricsLogger``), snapshots the train state every
``TRAIN.SNAPSHOT_ITERS`` steps and at the end into ``<out>/ckpt_<step>/``
(the newest 5 kept; ``utils.checkpoint.save_checkpoint``; the final state
is ``<out>/ckpt_<iters>/train_state.npz``) and resumes from the newest
snapshot under ``<out>``.  Each step draws its images and its random
numbers from generators seeded by (seed, step), so a resumed run takes the
same steps as one that was not interrupted.  It runs on the GPU unless
``--device cpu`` is given, and raises without one.  Real-data imdbs and
``TrainLoader`` (flipping, scaling) are not ported.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train MNC (PyTorch port, synthetic imdb)")
    ap.add_argument("--imdb", default="synthetic_64")
    ap.add_argument("--iters", type=int, default=None, help="max iterations")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--out", default=None, help="output dir (default output/<imdb>)")
    ap.add_argument("--ims-per-batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--gt-mask-size", type=int, default=28)
    ap.add_argument("--print-every", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mnc_tpu_torch.data.synthetic import SyntheticShapes
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.train.loop import TrainState, make_train_step, train_cfg_from_cfg
    from mnc_tpu_torch.train.optim import make_optimizer
    from mnc_tpu_torch.utils.checkpoint import (latest_checkpoint, restore_latest,
                                                save_checkpoint)
    from mnc_tpu_torch.utils.device import resolve_device
    from mnc_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    if not args.imdb.startswith("synthetic"):
        raise NotImplementedError(f"imdb {args.imdb!r}: only synthetic[_<n>] is ported")
    seed = args.seed if args.seed is not None else cfg.RNG_SEED
    n_images = int(args.imdb.split("_")[1]) if "_" in args.imdb else 64
    data = SyntheticShapes(gt_mask_size=args.gt_mask_size, num_images=n_images)

    # shrink the static shapes to the synthetic canvas
    arch = MNCArch.from_cfg(train=True, canvas=data.canvas_hw, num_classes=data.num_classes,
                            anchor_scales=(2, 4, 8), rpn_min_size=4.0)
    model = MNC(arch, device=device, seed=seed, train=True)
    opt = make_optimizer(
        model, base_lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, gamma=cfg.TRAIN.GAMMA,
        stepsize=cfg.TRAIN.STEPSIZE, iter_size=cfg.TRAIN.ITER_SIZE,
        clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
    step_fn = make_train_step(model, opt, arch, train_cfg_from_cfg(cfg))
    out_dir = args.out or os.path.join("output", args.imdb)
    state, start = restore_latest(out_dir, TrainState.create(model, opt))
    if start:
        print(f"resumed from iter {start}", flush=True)

    ims = args.ims_per_batch or cfg.TRAIN.IMS_PER_BATCH
    max_iters = args.iters or cfg.TRAIN.MAX_ITERS
    gen = torch.Generator(device=device)
    order = torch.Generator()
    print(f"training on {device} ({arch.n_stages}-stage, canvas {arch.canvas}, "
          f"{ims} image(s) per step, {max_iters} iters)", flush=True)
    logger = MetricsLogger(os.path.join(out_dir, "train_metrics.jsonl"), args.print_every)
    t0 = time.perf_counter()
    for it in range(start, max_iters):
        step_seed = int(np.random.SeedSequence([seed, it]).generate_state(1)[0])
        order.manual_seed(step_seed)
        gen.manual_seed(step_seed)
        idx = torch.randint(0, n_images, (ims,), generator=order).tolist()
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(idx).items()}
        lr = opt.lr
        state, metrics = step_fn(state, batch, gen)
        logger.log(it + 1, {k: float(v) for k, v in metrics.items()}, lr=lr)
        if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0 or it + 1 == max_iters:
            print(f"snapshot → {save_checkpoint(out_dir, state, step=it + 1)}", flush=True)
    logger.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    n = max(max_iters - start, 1)
    print(f"done: {max_iters} iters, avg {(time.perf_counter() - t0) / n:.3f} s/iter; "
          f"state → {latest_checkpoint(out_dir)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
