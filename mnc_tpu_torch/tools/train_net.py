"""Train MNC on the synthetic shapes imdb — the port's counterpart of
``tools/train_net.py`` for ``--imdb synthetic[_<n>]``.

    python3 -m mnc_tpu_torch.tools.train_net --imdb synthetic_64 --iters 100 \\
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...] [--out DIR] \\
        [--ims-per-batch N] [--seed S] [--device cpu]

Builds the architecture with ``MNCArch.from_cfg(train=True)`` and the
synthetic overrides (the imdb's canvas and classes, small anchors), the
solver from ``cfg.TRAIN.*``, prints one metrics line every ``--print-every``
steps and saves the train state as ``<out>/state_<iters>.npz`` at the end.
It runs on the GPU unless ``--device cpu`` is given, and raises without one.
Real-data imdbs, ``TrainLoader`` (flipping, scaling) and orbax snapshots are
not ported.
"""

from __future__ import annotations

import argparse
import os
import time


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
    from mnc_tpu_torch.utils.checkpoint import save_train_state
    from mnc_tpu_torch.utils.device import resolve_device

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
    state = TrainState.create(model, opt)

    ims = args.ims_per_batch or cfg.TRAIN.IMS_PER_BATCH
    max_iters = args.iters or cfg.TRAIN.MAX_ITERS
    out_dir = args.out or os.path.join("output", args.imdb)
    gen = torch.Generator(device=device).manual_seed(seed)
    order = torch.Generator().manual_seed(seed)
    print(f"training on {device} ({arch.n_stages}-stage, canvas {arch.canvas}, "
          f"{ims} image(s) per step, {max_iters} iters)", flush=True)
    t0 = time.perf_counter()
    for it in range(max_iters):
        idx = torch.randint(0, n_images, (ims,), generator=order).tolist()
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(idx).items()}
        lr = opt.lr
        state, metrics = step_fn(state, batch, gen)
        if (it + 1) % args.print_every == 0 or it == 0:
            parts = ", ".join(f"{k} = {float(v):.4f}" for k, v in metrics.items())
            print(f"Iteration {it + 1}, lr = {lr:.6g}: {parts}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"state_{max_iters}.npz")
    save_train_state(path, state)
    print(f"done: {max_iters} iters, avg {(time.perf_counter() - t0) / max_iters:.3f} s/iter; "
          f"state → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
