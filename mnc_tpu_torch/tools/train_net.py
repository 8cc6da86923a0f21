"""Train MNC — the port's counterpart of ``tools/train_net.py`` (≙ the
reference ``tools/train_net.py`` and its SolverWrapper loop).

    python3 -m mnc_tpu_torch.tools.train_net --imdb synthetic_64 --iters 100 \\
        [--cfg experiments/cfgs/x.yml] [--set KEY VAL ...] [--out DIR] \\
        [--weights vgg16.npz|mnc.caffemodel|resnet101.pth] \\
        [--ims-per-batch N] [--seed S] [--device cpu] \\
        [--segdb DIR [--seg-top-k 64]]

``--imdb`` names an imdb with masks that ``data.imdb.get_imdb`` resolves:
``synthetic[_<n>]``, ``voc_2012_seg_<set>`` (SBD), ``coco_<split>`` (both
under ``cfg.DATA_DIR``; ``--set DATA_DIR <dir>`` moves them) or a
registered name.  A synthetic imdb shrinks the architecture to its canvas
and classes (small anchors); any other takes
``MNCArch.from_cfg(train=True)``, its canvas from
``cfg.STATIC.CANVAS`` and its class count from the imdb (COCO's from the
json).  The solver comes from ``cfg.TRAIN.*``.  Every step's metrics go to
``<out>/train_metrics.jsonl`` and are printed every ``--print-every`` steps
(``utils.metrics.MetricsLogger``); the train state is snapshotted every
``TRAIN.SNAPSHOT_ITERS`` steps and at the end into ``<out>/ckpt_<step>/``
(the newest 5 kept; the final state is ``<out>/ckpt_<iters>/
train_state.npz``), and a run resumes from the newest snapshot under
``<out>``.  It runs on the GPU unless ``--device cpu`` is given, and raises
without one.

``--weights`` initializes the model before training, as the JAX tool does:
a caffe-export VGG-16 ``.npz`` (the trunk), a reference ``.caffemodel``
(every layer it has, ``bbox_pred`` re-normalized for training), or a
torchvision ``.pth`` state dict (VGG-16's trunk, or a ResNet's, which turns
on ``NET.RESNET_STRIDE_IN_3X3``: torchvision's ResNets are v1.5).

Each step's random numbers come from a generator seeded by (seed, step).
On a synthetic imdb the MNC path draws its images from the same seed, so a
resumed run takes the same steps as one that was not interrupted.  Real
imdbs, and ``--segdb DIR`` (CFM training, ``models/cfm.py``: the trunk and
the classify head on the precomputed segment proposals of
``tools.prepare_mcg_maskdb``, no RPN or mask-head loss), take their images
from ``data.loader.TrainLoader`` (the JAX package's shuffled,
flip-augmented order from the seed); a resumed run advances it past the
steps already taken, with the same effect.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train MNC (PyTorch port)")
    ap.add_argument("--imdb", default="synthetic_64")
    ap.add_argument("--iters", type=int, default=None, help="max iterations")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--weights", default=None,
                    help="initial weights: caffe-export VGG-16 .npz, .caffemodel, or a "
                         "torchvision .pth (VGG-16 or ResNet)")
    ap.add_argument("--out", default=None, help="output dir (default output/<imdb>)")
    ap.add_argument("--ims-per-batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--gt-mask-size", type=int, default=28)
    ap.add_argument("--print-every", type=int, default=20)
    ap.add_argument("--segdb", default=None,
                    help="CFM training: dir of per-image segment-proposal pkls "
                         "(mnc_tpu_torch.tools.prepare_mcg_maskdb)")
    ap.add_argument("--seg-top-k", type=int, default=64,
                    help="--segdb: segment proposals kept per image (padded)")
    return ap.parse_args(argv)


def load_weights(model, path: str, arch) -> None:
    """``--weights`` into ``model`` in place, by the file's kind, as the JAX
    tool's loaders do (``tools/train_net.py``): the VGG loaders and the
    caffemodel importer work on the JAX-layout tree of the model's
    parameters, the ResNet loader on its ``state_dict``."""
    from mnc_tpu_torch.utils import weights as W
    from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                renormalize_bbox_pred, state_dict_from_jax)

    if arch.trunk.startswith("resnet") and not path.endswith((".npz", ".caffemodel")):
        model.load_state_dict(W.load_resnet_torchvision(model.state_dict(), weights_path=path,
                                                        depth=int(arch.trunk[6:])))
        return
    params = jax_params_from_state_dict(model.state_dict())
    if path.endswith(".npz"):
        params = W.load_vgg16_caffe_npz(path, params)
    elif path.endswith(".caffemodel"):
        from mnc_tpu_torch.utils.caffemodel import load_mnc_caffemodel

        # a reference snapshot stores bbox_pred with the target statistics
        # folded in; training regresses normalized deltas
        params = renormalize_bbox_pred(load_mnc_caffemodel(path, params), arch.bbox_means,
                                       arch.bbox_stds)
        print(f"caffemodel bbox_pred re-normalized for training (stds {arch.bbox_stds})")
    else:
        params = W.load_vgg16_torchvision(params, weights_path=path)
    model.load_state_dict(state_dict_from_jax(params))


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mnc_tpu_torch.data.imdb import get_imdb
    from mnc_tpu_torch.data.loader import TrainLoader
    from mnc_tpu_torch.data.synthetic import SyntheticShapes
    from mnc_tpu_torch.models.cfm import make_cfm_train_step
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
    seed = args.seed if args.seed is not None else cfg.RNG_SEED
    synthetic = args.imdb.startswith("synthetic")
    imdb = None if synthetic else get_imdb(args.imdb)
    if (args.weights and cfg.NET.TRUNK.startswith("resnet")
            and not args.weights.endswith((".npz", ".caffemodel"))
            and not cfg.NET.RESNET_STRIDE_IN_3X3):
        # torchvision's ResNets are v1.5 (stride on the 3x3): v1 geometry
        # fits every shape but computes features the weights never saw
        print("torchvision ResNet weights: enabling NET.RESNET_STRIDE_IN_3X3 "
              "(v1.5 geometry the checkpoint was trained with)", flush=True)
        cfg.NET.RESNET_STRIDE_IN_3X3 = True
    if synthetic:  # shrink the static shapes to the synthetic canvas
        n_images = int(args.imdb.split("_")[1]) if "_" in args.imdb else 64
        data = SyntheticShapes(gt_mask_size=args.gt_mask_size, num_images=n_images)
        arch = MNCArch.from_cfg(train=True, canvas=data.canvas_hw,
                                num_classes=data.num_classes, anchor_scales=(2, 4, 8),
                                rpn_min_size=4.0)
    else:
        arch = MNCArch.from_cfg(train=True, num_classes=imdb.num_classes)
    model = MNC(arch, device=device, seed=seed, train=True)
    if args.weights:
        load_weights(model, args.weights, arch)
        print(f"initialized from {args.weights}", flush=True)
    opt = make_optimizer(
        model, base_lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, gamma=cfg.TRAIN.GAMMA,
        stepsize=cfg.TRAIN.STEPSIZE, iter_size=cfg.TRAIN.ITER_SIZE,
        clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
    train_cfg = train_cfg_from_cfg(cfg)
    out_dir = args.out or os.path.join("output", args.imdb)
    state, start = restore_latest(out_dir, TrainState.create(model, opt))
    if start:
        print(f"resumed from iter {start}", flush=True)

    ims = args.ims_per_batch or cfg.TRAIN.IMS_PER_BATCH
    max_iters = args.iters or cfg.TRAIN.MAX_ITERS
    if args.segdb:
        step_fn = make_cfm_train_step(model, opt, arch, dict(train_cfg,
                                                             CFM_IOU=cfg.TRAIN.CFM_IOU))
        print(f"CFM training on segment proposals from {args.segdb} (top {args.seg_top_k} "
              "per image; no RPN or mask-head losses)", flush=True)
    else:
        step_fn = make_train_step(model, opt, arch, train_cfg)
    loader = None
    if args.segdb or not synthetic:
        loader = TrainLoader(imdb or get_imdb(args.imdb), canvas_hw=arch.canvas,
                             ims_per_batch=ims, gt_mask_size=args.gt_mask_size, seed=seed,
                             segdb_dir=args.segdb, seg_top_k=args.seg_top_k)
        loader.skip(start * ims)  # the examples of the steps already taken
    else:
        order = torch.Generator()
    gen = torch.Generator(device=device)
    print(f"training on {device} ({arch.n_stages}-stage, canvas {arch.canvas}, "
          f"{arch.num_classes} classes, {ims} image(s) per step, {max_iters} iters)",
          flush=True)
    logger = MetricsLogger(os.path.join(out_dir, "train_metrics.jsonl"), args.print_every)
    t0 = time.perf_counter()
    try:
        for it in range(start, max_iters):
            step_seed = int(np.random.SeedSequence([seed, it]).generate_state(1)[0])
            gen.manual_seed(step_seed)
            if loader is not None:
                host = next(loader)
            else:
                order.manual_seed(step_seed)
                host = data.batch(torch.randint(0, n_images, (ims,), generator=order).tolist())
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in host.items()}
            lr = opt.lr
            state, metrics = step_fn(state, batch, gen)
            logger.log(it + 1, {k: float(v) for k, v in metrics.items()}, lr=lr)
            if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0 or it + 1 == max_iters:
                print(f"snapshot → {save_checkpoint(out_dir, state, step=it + 1)}", flush=True)
    finally:
        if loader is not None:
            loader.close()
        logger.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    n = max(max_iters - start, 1)
    print(f"done: {max_iters} iters, avg {(time.perf_counter() - t0) / n:.3f} s/iter; "
          f"state → {latest_checkpoint(out_dir)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
