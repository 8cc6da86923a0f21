"""Train → detect → mAP^r in one process — the port's counterpart of
``tools/e2e_synth_demo.py``.

Trains the 5-stage cascade on synthetic shapes (``SyntheticIMDB``, seed 1),
then evaluates mAP^r@0.5/0.7 on a validation set (seed 99) through
``MNCPipeline.detect_canvas_packed`` and the SDS evaluator, prints the
reference-style AP tables and ends with one JSON line:

    python3 -m mnc_tpu_torch.tools.e2e_synth_demo [--iters 300] [--batch 8] \\
        [--eval-images 8] [--eval-every 1000] [--full-scale [--trunk resnet101 \\
        --roi-conv5]] [--int8-eval] [--init-params P.npz] [--device cpu]

The small configuration (96×128 canvas, f32, FC 256) trains from scratch in
minutes; ``--full-scale`` is the reference-scale architecture (640×1024,
full VGG-16 heads or a ResNet trunk, bf16), with the trunk rematerialized
in the backward (``MNCArch.remat_trunk``) for every trunk but VGG-16.  The
whole training set is staged on the device once and each iteration's batch
is a gather there; with ``--batch`` > 1 the image indices come from
``np.random.RandomState(seed + 7)``, as in the JAX tool, so both take their
images in the same order.  The step's random numbers come from a
``torch.Generator`` seeded with ``--seed``, which also seeds the init.

``--eval-every N`` appends a learning curve to ``<out>/e2e_metrics.jsonl``
(one JSON object per evaluation, the final one included).  The trained
parameters go to ``<out>/e2e_params.npz`` in the JAX package's parameter
format (either package's tools read the other's); ``--init-params`` starts
from such a file, after checking its shapes against the architecture.
``--int8-eval`` evaluates the same weights again under ``int8_inference``
(``TEST.INT8``).  It runs on the GPU unless ``--device cpu`` is given, and
raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# the JAX tool's sampling and loss settings for each architecture
TRAIN_CFG_FULL = dict(
    RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=256,
    RPN_FG_FRACTION=0.5, BATCH_SIZE=128, FG_FRACTION=0.25, FG_THRESH=0.5,
    BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
TRAIN_CFG_SMALL = dict(
    RPN_POSITIVE_OVERLAP=0.6, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=128,
    RPN_FG_FRACTION=0.5, BATCH_SIZE=64, FG_FRACTION=0.25, FG_THRESH=0.5,
    BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train -> detect -> mAP^r (PyTorch port)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--init-params", default=None,
                    help="npz checkpoint (JAX parameter format) to fine-tune from")
    ap.add_argument("--n-range", type=int, nargs=2, default=None, metavar=("MIN", "MAX"),
                    help="instances per synthetic image (with --max-gt)")
    ap.add_argument("--max-gt", type=int, default=None,
                    help="gt capacity per image (override for crowded scenes)")
    ap.add_argument("--eval-images", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate mAP^r every N iters (0 = only at the end)")
    ap.add_argument("--train-images", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--stepsize", type=int, default=None,
                    help="step-LR decay point (default 3/4 of iters)")
    ap.add_argument("--int8-eval", action="store_true",
                    help="also evaluate the final weights under int8_inference (TEST.INT8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="output")
    ap.add_argument("--trunk", default="vgg16", choices=("vgg16", "resnet50", "resnet101"),
                    help="conv trunk (--full-scale only)")
    ap.add_argument("--mask-size", type=int, default=21, help="MASK_SIZE (--full-scale only)")
    ap.add_argument("--pre-nms", type=int, default=2048,
                    help="train pre-NMS working set (--full-scale only; reference 12000)")
    ap.add_argument("--post-nms", type=int, default=512,
                    help="train post-NMS RoI count (--full-scale only; reference 2000)")
    ap.add_argument("--roi-conv5", action="store_true",
                    help="ResNet per-RoI conv5 classify head instead of the fc6/fc7 tower")
    ap.add_argument("--full-scale", action="store_true",
                    help="reference-scale arch: 640x1024 canvas, full heads, anchors "
                         "(8,16,32)x16")
    ap.add_argument("--anchor-scales", type=int, nargs="*", default=None,
                    help="override NET.ANCHOR_SCALES (--full-scale only)")
    return ap.parse_args(argv)


def build_arch(args):
    """(arch, train_cfg, gt mask size, gt capacity) of the JAX tool's two
    configurations."""
    import torch

    from mnc_tpu_torch.models.mnc import MNCArch

    if args.full_scale:
        arch = MNCArch(
            canvas=(640, 1024), anchor_scales=tuple(args.anchor_scales or (8, 16, 32)),
            num_classes=6, mask_size=args.mask_size, warp_hw=14, n_stages=5, fc_dim=4096,
            mask_fc_dim=256, pre_nms_top_n=args.pre_nms, post_nms_top_n=args.post_nms,
            rpn_min_size=16.0, trunk=args.trunk, trunk_frozen=0,
            # a deep trunk's activations at the full canvas dominate the
            # backward's memory
            remat_trunk=args.trunk != "vgg16", roi_conv5=args.roi_conv5)
        train_cfg, gt_mask_size, max_gt = TRAIN_CFG_FULL, 28, 6
    else:
        arch = MNCArch(
            canvas=(96, 128), anchor_scales=(1, 2, 4), num_classes=4, mask_size=13,
            warp_hw=6, n_stages=5, compute_dtype=torch.float32, fc_dim=256, mask_fc_dim=256,
            pre_nms_top_n=192, post_nms_top_n=48, rpn_min_size=4.0,
            trunk_frozen=0)  # from scratch: do not freeze random filters
        train_cfg, gt_mask_size, max_gt = TRAIN_CFG_SMALL, 24, 4
    if args.max_gt is not None:
        max_gt = args.max_gt
    return arch, train_cfg, gt_mask_size, max_gt


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def evaluate(pipe, val, val_ex, gt, verbose=False):
    """mAP^r @0.5 and @0.7 of ``pipe`` on the validation images.  During
    training ``pipe`` holds the training model itself: its f32 master
    parameters, cast to the compute dtype in each layer."""
    from mnc_tpu_torch.data.eval_sds import collect_detections, eval_sds, print_ap_table
    from mnc_tpu_torch.pipeline.inference import unpack_canvas_masks

    dets = []
    for i, ex in zip(val.image_index, val_ex):
        out = _host(pipe.detect_canvas_packed(ex["image"], ex["im_info"]))
        out = unpack_canvas_masks(out, pipe.arch.canvas[1])
        dets.extend(collect_detections(out, i, score_thresh=0.05))
    r5 = eval_sds(dets, gt, val.num_classes, 0.5)
    r7 = eval_sds(dets, gt, val.num_classes, 0.7)
    if verbose:
        print(print_ap_table(r5, val.classes), flush=True)
        print(print_ap_table(r7, val.classes), flush=True)
    return r5, r7


def int8_evaluate(model, post, val, val_ex, gt):
    """The same weights under ``int8_inference`` (kernels E and F on the
    card): the accuracy half of the quantization trade."""
    import dataclasses

    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline

    qmodel = MNC(dataclasses.replace(model.arch, int8_inference=True), device=model.device,
                 seed=None)
    qmodel.load_state_dict(model.state_dict())
    return evaluate(MNCPipeline(qmodel, post), val, val_ex, gt)


def _check_init_params(model, path: str) -> dict:
    """The state dict of an npz, after checking its shapes against ``model``."""
    from mnc_tpu_torch.utils.checkpoint import load_npz, state_dict_from_jax

    loaded = state_dict_from_jax(load_npz(path)[0])
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in loaded.items()}
    if have != got:
        diff = sorted(set(have.items()) ^ set(got.items()))[:6]
        raise SystemExit(f"--init-params checkpoint shape mismatch with this arch: {diff}")
    return loaded


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg
    from mnc_tpu_torch.train.loop import TrainState, build_train_step
    from mnc_tpu_torch.train.optim import make_optimizer
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    arch, train_cfg, gt_mask_size, max_gt = build_arch(args)
    n_range_kw = {} if args.n_range is None else {"n_range": tuple(args.n_range)}
    data_kw = dict(canvas_hw=arch.canvas, num_classes=arch.num_classes, max_gt=max_gt,
                   gt_mask_size=gt_mask_size, **n_range_kw)
    imdb = SyntheticIMDB(num_images=args.train_images, seed=1, **data_kw)
    val = SyntheticIMDB(num_images=args.eval_images, seed=99, **data_kw)

    model = MNC(arch, device=device, seed=args.seed, train=True)
    if args.init_params:
        model.load_state_dict(_check_init_params(model, args.init_params))
        print(f"fine-tuning from {args.init_params}", flush=True)
    stepsize = args.stepsize or max(args.iters * 3 // 4, 1)
    opt = make_optimizer(model, base_lr=args.lr, stepsize=stepsize, clip_gradients=10.0)
    step = build_train_step(model, opt, arch, train_cfg)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    # the whole (small) training set on the device; a batch is a gather there
    all_ex = {k: torch.from_numpy(v).to(device)
              for k, v in imdb.gen.batch(imdb.image_index).items()}
    rs = np.random.RandomState(args.seed + 7)

    os.makedirs(args.out, exist_ok=True)
    curve_f = open(os.path.join(args.out, "e2e_metrics.jsonl"), "a")
    val_ex = [val.example(i) for i in val.image_index]
    gt = val.gt_instances()
    post = PostCfg(dets_per_class=8, max_per_image=12, vote_top_k=24, score_thresh=0.01)
    pipe = MNCPipeline(model, post)

    t0 = time.time()
    t_eval, n_eval = 0.0, 0
    metrics = None
    try:
        for it in range(args.iters):
            if args.batch == 1:
                i = it % imdb.num_images
                batch = {k: v[i] for k, v in all_ex.items()}
            else:
                idx = torch.as_tensor(rs.randint(0, imdb.num_images, size=args.batch),
                                      device=device)
                batch = {k: v[idx] for k, v in all_ex.items()}
            state, metrics = step(state, batch, gen)
            if (it + 1) % 100 == 0 or it == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"iter {it + 1}: total={m['total']:.3f} mask={m['s23_mask']:.3f} "
                      f"cls={m['s23_cls']:.3f} ({time.time() - t0:.0f}s)", flush=True)
            if args.eval_every and (it + 1) % args.eval_every == 0 and it + 1 < args.iters:
                t1 = time.time()
                r5, r7 = evaluate(pipe, val, val_ex, gt)
                t_eval += time.time() - t1
                n_eval += 1
                rec = {"iter": it + 1, "map_r_050": round(r5["map"], 4),
                       "map_r_070": round(r7["map"], 4),
                       "total_loss": round(float(metrics["total"]), 4),
                       "wall_s": round(time.time() - t0, 1)}
                print("EVAL " + json.dumps(rec), flush=True)
                curve_f.write(json.dumps(rec) + "\n")
                curve_f.flush()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_train = time.time() - t0 - t_eval
        print(f"trained {args.iters} iters in {time.time() - t0:.0f}s "
              f"({t_train / max(args.iters, 1) * 1e3:.1f} ms/iter; {n_eval} evaluations "
              f"{t_eval:.1f}s)", flush=True)
        save_npz(os.path.join(args.out, "e2e_params.npz"),
                 jax_params_from_state_dict(model.state_dict()))

        # network-level diagnostics on one validation image
        ex = val_ex[0]
        net = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in _host(model(torch.as_tensor(ex["image"], device=device),
                                       torch.as_tensor(ex["im_info"], device=device))).items()}
        print("netdiag: roi_valid=", int(net["roi_valid"].sum()),
              " cls_prob max per class=", np.round(net["cls_prob"].max(0), 3).tolist(),
              " bg prob mean=", round(float(net["cls_prob"][:, 0].mean()), 3),
              " rois[:3]=", np.round(net["rois"][:3], 1).tolist(), flush=True)

        t1 = time.time()
        r5, r7 = evaluate(pipe, val, val_ex, gt, verbose=True)
        print(f"evaluated {len(val_ex)} images in {time.time() - t1:.2f}s", flush=True)
        rec = {"iter": args.iters, "map_r_050": round(r5["map"], 4),
               "map_r_070": round(r7["map"], 4),
               "total_loss": (round(float(metrics["total"]), 4)
                              if metrics is not None else None),
               "wall_s": round(time.time() - t0, 1)}
        curve_f.write(json.dumps(rec) + "\n")
    finally:
        curve_f.close()
    final = {"map_r_050": round(r5["map"], 4), "map_r_070": round(r7["map"], 4),
             "iters": args.iters, "batch": args.batch}
    if args.int8_eval:
        t1 = time.time()
        q5, q7 = int8_evaluate(model, post, val, val_ex, gt)
        print(f"int8 evaluation of {len(val_ex)} images in {time.time() - t1:.2f}s "
              "(model build included)", flush=True)
        final["int8_map_r_050"] = round(q5["map"], 4)
        final["int8_map_r_070"] = round(q7["map"], 4)
    print(json.dumps(final))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
