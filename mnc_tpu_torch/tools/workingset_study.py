"""Pre-NMS working-set and per-class-capacity study — the port's counterpart
of ``tools/workingset_study.py``.

The build defaults to a test-time pre-NMS top-1024 where the reference used
6000, and caps per-class detections at 16 where the reference kept every
NMS survivor.  This measures what the defaults cost on a TRAINED full-scale
model (an ``e2e_synth_demo`` npz in the JAX parameter format) over the
synthetic validation set:

  - proposal recall: the share of valid gt boxes that a proposal covers at
    IoU .5 / .7 (features → RPN → ``propose_rois`` → ``bbox_overlaps``);
  - detection mAP^r @0.5 / @0.7;
  - ms per image of ``detect_canvas_packed`` (host clock, after a
    ``torch.cuda.synchronize()``, the copy to the host included);

over the ``--pre-nms`` sweep (dets_per_class 16), the ``--post-nms`` sweep
at the last pre-NMS value (max_per_image lifted to 304) and the other
``--dets-per-class`` values at pre-NMS 1024:

    python3 -m mnc_tpu_torch.tools.workingset_study --params output/e2e_params.npz \\
        [--pre-nms 512 1024 2048 6000] [--post-nms 304 1000] [--dets-per-class 16 100] \\
        [--instances 20 30 --seed 202] [--append results.jsonl] [--smoke] [--device cpu]

The npz is read once and the model built once: the sweeps change only the
pre- and post-NMS budgets, which no parameter depends on, so each point
runs the same modules under its own architecture record.  One JSON record
per point, then the ``summary:`` table.  ``--smoke``, an addition of the
port, takes the tiny f32 architecture of ``crowd_study --smoke`` with the
port's seeded random parameters (or ``--params`` when given), at most 4
images.  It runs on the GPU unless ``--device cpu`` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

DEFAULT_PARAMS = "output/e2e_fullscale_r2b/e2e_params.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="pre-NMS working-set study (PyTorch port)")
    ap.add_argument("--params", default=None, help=f"npz weights (default {DEFAULT_PARAMS}; "
                    "under --smoke the seeded init unless given)")
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--instances", type=int, nargs=2, default=None,
                    metavar=("MIN", "MAX"),
                    help="instances per val image (default: generator "
                         "default ≤6; use with --seed 202 to reproduce the "
                         "crowd_study val set)")
    ap.add_argument("--seed", type=int, default=99, help="val generator seed")
    ap.add_argument("--post-nms", type=int, nargs="*", default=None,
                    help="additional sweep: post-NMS proposal budgets at the "
                         "LAST --pre-nms value (reference test-time is 300; "
                         "also lifts max_per_image to 304 for these runs)")
    ap.add_argument("--pre-nms", type=int, nargs="*",
                    default=(512, 1024, 2048, 6000))
    ap.add_argument("--dets-per-class", type=int, nargs="*", default=(16, 100))
    ap.add_argument("--append", default=None,
                    help="append result JSON lines to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny arch + seeded random params (plumbing check)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.eval_images = min(args.eval_images, 4)
    return args


def base_arch(args):
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.tools.ablation_study import smoke_arch

    if args.smoke:
        return smoke_arch()
    return MNCArch(canvas=(640, 1024), anchor_scales=(8, 16, 32), num_classes=6, mask_size=21,
                   warp_hw=14, n_stages=5, fc_dim=4096, mask_fc_dim=256, pre_nms_top_n=2048,
                   post_nms_top_n=304, rpn_min_size=16.0, trunk_frozen=0)


def sweep(base, args) -> list:
    """(label, arch, PostCfg) of every point of the study, in its order."""
    from mnc_tpu_torch.pipeline.inference import PostCfg

    rep = dataclasses.replace
    points = []
    for p in args.pre_nms:
        points.append((f"pre_nms={p},dets_per_class=16", rep(base, pre_nms_top_n=p),
                       PostCfg(dets_per_class=16, max_per_image=100, vote_top_k=64,
                               score_thresh=0.01)))
    for pn in (args.post_nms or ()):
        points.append((f"pre_nms={args.pre_nms[-1]},post_nms={pn},dets_per_class=16",
                       rep(base, pre_nms_top_n=args.pre_nms[-1], post_nms_top_n=pn),
                       PostCfg(dets_per_class=16, max_per_image=304, vote_top_k=64,
                               score_thresh=0.01)))
    for d in args.dets_per_class:
        if d == 16:
            continue  # covered above at every pre_nms
        points.append((f"pre_nms=1024,dets_per_class={d}", rep(base, pre_nms_top_n=1024),
                       PostCfg(dets_per_class=d, max_per_image=100, vote_top_k=64,
                               score_thresh=0.01)))
    return points


def with_arch(model, arch):
    """``model`` under another pre-/post-NMS budget: the same modules and
    parameter tensors, its own ``arch`` (the canvas, hence the anchors, is
    the same)."""
    variant = model.for_canvas(arch.canvas)
    variant.arch = arch
    return variant


def best_overlaps(model, ex, device) -> np.ndarray:
    """The best IoU of any valid proposal with each valid gt box of one
    example (features → RPN → ``propose_rois`` → ``bbox_overlaps``)."""
    import torch

    from mnc_tpu_torch.models.mnc import propose_rois
    from mnc_tpu_torch.ops.bbox import bbox_overlaps

    with torch.no_grad():
        feat = model.features(torch.as_tensor(ex["image"], device=device)[None])
        rpn_cls, rpn_bbox = model.rpn(feat)
        rois, valid, _ = propose_rois(rpn_cls, rpn_bbox,
                                      torch.as_tensor(ex["im_info"], device=device)[None],
                                      model.anchors, model.arch)
        ov = bbox_overlaps(torch.as_tensor(ex["gt_boxes"], device=device), rois[0])
        best = torch.where(valid[0][None, :], ov, torch.zeros_like(ov)).max(dim=1).values
    return best.cpu().numpy()[np.asarray(ex["gt_valid"], bool)]


def evaluate(model, post, val_ex, gt, num_classes, device, label) -> dict:
    """One point's record: recall, mAP^r and ms per image."""
    from mnc_tpu_torch.data.eval_sds import eval_sds
    from mnc_tpu_torch.pipeline.inference import MNCPipeline
    from mnc_tpu_torch.tools.ablation_study import detect_all

    dets, t_det = detect_all(MNCPipeline(model, post), val_ex, device)
    best = np.concatenate([best_overlaps(model, ex, device) for _, ex in val_ex])
    return {
        "config": label,
        "recall@.5": round(float((best >= 0.5).mean()), 4),
        "recall@.7": round(float((best >= 0.7).mean()), 4),
        "map_r_050": round(eval_sds(dets, gt, num_classes, 0.5)["map"], 4),
        "map_r_070": round(eval_sds(dets, gt, num_classes, 0.7)["map"], 4),
        "ms_per_img": round(t_det / len(val_ex) * 1e3, 1),
    }


def validation_set(base, args):
    """(imdb, [(id, example)], gt) of ``--seed`` / ``--instances``."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

    gen_kw = dict(max_gt=6)
    if args.instances:
        gen_kw = dict(max_gt=args.instances[1], n_range=tuple(args.instances))
    val = SyntheticIMDB(canvas_hw=base.canvas, num_classes=base.num_classes, gt_mask_size=28,
                        num_images=args.eval_images, seed=args.seed, **gen_kw)
    return val, [(i, val.example(i)) for i in val.image_index], val.gt_instances()


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.tools.crowd_study import load_model
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    base = base_arch(args)
    model = load_model(base, args.params or (None if args.smoke else DEFAULT_PARAMS), device,
                       args.smoke)
    val, val_ex, gt = validation_set(base, args)
    results = []
    for label, arch, post in sweep(base, args):
        rec = evaluate(with_arch(model, arch), post, val_ex, gt, val.num_classes, device,
                       label)
        print(json.dumps(rec), flush=True)
        if args.append:
            with open(args.append, "a") as f:
                f.write(json.dumps(rec) + "\n")
        results.append(rec)

    print("\nsummary:")
    for r in results:
        print(f"  {r['config']:<32} recall .5/.7 = {r['recall@.5']:.3f}/"
              f"{r['recall@.7']:.3f}  mAP .5/.7 = {r['map_r_050']:.3f}/"
              f"{r['map_r_070']:.3f}  {r['ms_per_img']:.0f} ms/img")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
