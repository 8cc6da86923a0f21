"""Cascade and voting ablation — the port's counterpart of
``tools/ablation_study.py``.

Evaluates ONE trained full-scale model (an ``e2e_synth_demo`` npz in the JAX
parameter format) under the cascade variants, all on the same weights
(stages 4-5 reuse the stage-2/3 parameters), so the differences are the
cascade's alone:

    3stage             stages 1-3 only (no bridge, no second pass)
    5stage_nobboxreg   5 stages with TEST.BBOX_REG off (unrefined boxes)
    5stage             the shipped default
    5stage_novote      mask voting off (TEST.USE_MASK_MERGE false)
    5stage_voteboth    both passes pooled as voting candidates
    5stage_nosuppress  every anchor type scored (suppress_untrainable_anchors off)
    5stage_int8        int8_inference (TEST.INT8; kernels E and F on the card)
    5stage_voteboxes   score-weighted box averaging too (TEST.VOTE_BOXES)

    python3 -m mnc_tpu_torch.tools.ablation_study --params output/e2e_params.npz \\
        [--eval-images 256 --val-seeds 99 7] [--bootstrap 1000 [--only 5stage] \\
        --append results.jsonl] [--coco-ap] [--smoke] [--device cpu]

Each variant prints one JSON record (mAP^r @0.5 / @0.7, ms per image of
``detect_canvas_packed`` on the host clock with a synchronize, the flags).
The validation images are split over ``--val-seeds`` (ids ``s{seed}:{i}``).
``--bootstrap N`` adds image-level 95% intervals from N resamples drawn by
``RandomState(0)``, shared by every variant and process, and, with
``--append``, stores each variant's resampled mAPs in ``<append>.boot.npz``,
so that a variant run later (``--only``) gets its paired deltas against
``--baseline`` (run that one first).  ``--smoke`` takes the tiny f32
architecture with seeded random parameters.  It runs on the GPU unless
``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="cascade / voting ablation (PyTorch port)")
    ap.add_argument("--params", default="output/e2e_fullscale_24k/e2e_params.npz")
    ap.add_argument("--eval-images", type=int, default=64,
                    help="TOTAL eval images, split across --val-seeds")
    ap.add_argument("--val-seeds", type=int, nargs="*", default=[99],
                    help="val-set generator seeds")
    ap.add_argument("--bootstrap", type=int, default=0,
                    help="N image-level bootstrap resamples: 95%% CI per variant and paired "
                         "delta CI vs --baseline (shared resample indices)")
    ap.add_argument("--baseline", default="5stage",
                    help="variant the paired bootstrap deltas compare to")
    ap.add_argument("--only", default=None, help="run a single variant")
    ap.add_argument("--pre-nms", type=int, default=1024)
    ap.add_argument("--mask-size", type=int, default=21,
                    help="must match the trained checkpoint's MASK_SIZE")
    ap.add_argument("--coco-ap", action="store_true",
                    help="also report COCO-style averaged AP^r@[.5:.95] per variant")
    ap.add_argument("--append", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny arch + seeded random params (plumbing check)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.eval_images = min(args.eval_images, 4)
    return args


def smoke_arch():
    """The tiny f32 architecture of the tools' ``--smoke`` (the JAX tools')."""
    import torch

    from mnc_tpu_torch.models.mnc import MNCArch

    return MNCArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, n_stages=5, fc_dim=48, mask_fc_dim=24, pre_nms_top_n=64,
                   post_nms_top_n=16, rpn_min_size=4.0, compute_dtype=torch.float32)


def base_arch(args):
    from mnc_tpu_torch.models.mnc import MNCArch

    if args.smoke:
        return smoke_arch()
    return MNCArch(canvas=(640, 1024), anchor_scales=(8, 16, 32), num_classes=6,
                   mask_size=args.mask_size, warp_hw=14, n_stages=5, fc_dim=4096,
                   mask_fc_dim=256, pre_nms_top_n=args.pre_nms, post_nms_top_n=304,
                   rpn_min_size=16.0, trunk_frozen=0)


def variants(base, post0) -> dict:
    """label → (arch, post) of the 8 variants."""
    rep = dataclasses.replace
    return {
        "3stage": (rep(base, n_stages=3), post0),
        "5stage_nobboxreg": (rep(base, test_bbox_reg=False), post0),
        "5stage": (base, post0),
        "5stage_novote": (base, rep(post0, use_mask_merge=False)),
        "5stage_voteboth": (base, rep(post0, vote_both_passes=True)),
        "5stage_nosuppress": (rep(base, suppress_untrainable_anchors=False), post0),
        "5stage_int8": (rep(base, int8_inference=True), post0),
        "5stage_voteboxes": (base, rep(post0, vote_boxes=True)),
    }


def validation_set(base, args):
    """(val_ex [(id, example)], ids, gt) over ``--val-seeds``."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

    per_seed = max(1, args.eval_images // len(args.val_seeds))
    val_ex, ids, gt = [], [], {}
    for seed in args.val_seeds:
        val = SyntheticIMDB(canvas_hw=base.canvas, num_classes=base.num_classes, max_gt=6,
                            gt_mask_size=28, num_images=per_seed, seed=seed)
        seed_gt = val.gt_instances()
        for i in val.image_index:
            iid = f"s{seed}:{i}"
            ids.append(iid)
            gt[iid] = seed_gt[i]
            val_ex.append((iid, val.example(i)))
    return val_ex, ids, gt


def detect_all(pipe, examples, device) -> tuple[list, float]:
    """``pipe.detect_canvas_packed`` over ``examples`` [(image id, example)]:
    (evaluator records at score 0.05, seconds of the detect calls with a
    synchronize and the copy to the host)."""
    import torch

    from mnc_tpu_torch.data.eval_sds import collect_detections
    from mnc_tpu_torch.pipeline.inference import unpack_canvas_masks

    dets, t_det = [], 0.0
    for iid, ex in examples:
        t0 = time.perf_counter()
        out = pipe.detect_canvas_packed(ex["image"], ex["im_info"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        t_det += time.perf_counter() - t0
        out = unpack_canvas_masks(out, pipe.arch.canvas[1])
        dets.extend(collect_detections(out, iid, score_thresh=0.05))
    return dets, t_det


def run_variant(arch, post, state_dict, val_ex, device):
    """One variant's detections over the validation images: (evaluator
    records, seconds of ``detect_canvas_packed`` including the copy to the
    host)."""
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline

    model = MNC(arch, device=device, seed=None)  # no random init: the weights are loaded
    model.load_state_dict(state_dict)
    return detect_all(MNCPipeline(model, post), val_ex, device)


def run_variants(params: dict, args, device) -> tuple[list, dict]:
    """The ablation on ``params`` (a JAX-layout parameter tree, e.g. from
    ``load_npz`` or converted from the JAX package): one record per variant
    (``--only`` picks one), appended to ``--append`` as it is made.
    Returns (records, {label: evaluator detections})."""
    from mnc_tpu_torch.data.eval_sds import (bootstrap_map_ci, eval_sds, eval_sds_averaged,
                                             eval_sds_matches)
    from mnc_tpu_torch.pipeline.inference import PostCfg
    from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax

    base = base_arch(args)
    val_ex, ids, gt = validation_set(base, args)
    num_classes = base.num_classes
    resamples = None
    if args.bootstrap:
        resamples = np.random.RandomState(0).randint(0, len(ids),
                                                     size=(args.bootstrap, len(ids)))
    post0 = PostCfg(dets_per_class=16, max_per_image=100, vote_top_k=64, score_thresh=0.01)
    todo = variants(base, post0)
    if args.only:
        todo = {args.only: todo[args.only]}
    state_dict = state_dict_from_jax(params)
    results, all_dets = [], {}
    for label, (arch, post) in todo.items():
        dets, t_det = run_variant(arch, post, state_dict, val_ex, device)
        all_dets[label] = dets
        rec = {
            "config": label,
            "map_r_050": round(eval_sds(dets, gt, num_classes, 0.5)["map"], 4),
            "map_r_070": round(eval_sds(dets, gt, num_classes, 0.7)["map"], 4),
            "ms_per_img": round(t_det / len(val_ex) * 1e3, 1),
            "pre_nms": args.pre_nms,
            "mask_size": args.mask_size,
            "n_images": len(val_ex),
            "val_seeds": args.val_seeds,
        }
        if args.coco_ap:
            rec["map_r_avg"] = round(eval_sds_averaged(dets, gt, num_classes)["map"], 4)
        if args.bootstrap:
            boot = {}
            for key, thr in (("050", 0.5), ("070", 0.7)):
                m = eval_sds_matches(dets, gt, num_classes, thr)
                maps, ci = bootstrap_map_ci(m, ids, resamples=resamples)
                rec[f"ci_{key}"] = [round(ci[0], 4), round(ci[1], 4)]
                boot[key] = maps
            rec["n_boot"] = args.bootstrap
            # the resampled mAPs persist, so that a later --only process can
            # pair against them (same flags: same resample indices)
            if args.append:
                bpath = args.append + ".boot.npz"
                store = dict(np.load(bpath)) if os.path.exists(bpath) else {}
                for key, maps in boot.items():
                    store[f"{label}:{key}"] = maps
                np.savez(bpath, **store)
                if label != args.baseline:
                    for key in ("050", "070"):
                        bk = f"{args.baseline}:{key}"
                        if bk in store:
                            d = boot[key] - store[bk]
                            lo, hi = np.percentile(d, [2.5, 97.5])
                            rec[f"delta_{key}_vs_{args.baseline}"] = [
                                round(float(d.mean()), 4), round(float(lo), 4),
                                round(float(hi), 4)]
        print(json.dumps(rec), flush=True)
        if args.append:
            with open(args.append, "a") as f:
                f.write(json.dumps(rec) + "\n")
        results.append(rec)
    return results, all_dets


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, load_npz
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    if args.smoke:
        params = jax_params_from_state_dict(MNC(base_arch(args), device="cpu", seed=0,
                                                train=True).state_dict())
    else:
        params = load_npz(args.params)[0]
    results, _ = run_variants(params, args, device)
    print("\nsummary:")
    for r in results:
        avg = f"  avg[.5:.95]={r['map_r_avg']:.3f}" if "map_r_avg" in r else ""
        print(f"  {r['config']:<18} mAP^r .5/.7 = {r['map_r_050']:.3f}/"
              f"{r['map_r_070']:.3f}{avg}  {r['ms_per_img']:.0f} ms/img")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
