"""Crowded-scene capacity study — the port's counterpart of
``tools/crowd_study.py``.

``dets_per_class=16`` and ``vote_top_k=64`` cost nothing at ≤6 instances an
image; the reference kept ALL per-class NMS survivors and voted over all
candidates.  This measures the caps at crowd densities (20-30 instances an
image, ``SyntheticIMDB(seed=202)``) with a trained full-scale model (an
``e2e_synth_demo`` npz in the JAX parameter format):

    python3 -m mnc_tpu_torch.tools.crowd_study --params output/e2e_params.npz \\
        [--dets-per-class 16 64 100] [--vote-top-k 64 0] [--only 16,0] \\
        [--append results.jsonl] [--smoke [--params P.npz]] [--device cpu]

Each (dets_per_class, vote_top_k) configuration prints one JSON record:
mAP^r @0.5 / @0.7, ms per image of ``detect_canvas_packed`` (host clock,
after a ``torch.cuda.synchronize()``, the copy to the host included) and
``max_dets_per_image_class``, the largest count of reported detections of
one class in one image (below ``dets_per_class``, the cap did not bind);
``vote_top_k`` 0 means all candidates (the reference behaviour).  Then the
``summary:`` table.  ``--smoke`` takes the tiny f32 architecture with the
port's seeded random parameters (``MNC(seed=0)``), at most 4 images; unlike
the JAX tool, it also takes ``--params`` (parameters of that architecture,
e.g. the JAX smoke model's, saved by ``save_npz``).  It runs on the GPU
unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

DEFAULT_PARAMS = "output/e2e_fullscale_24k/e2e_params.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="crowded-scene capacity study (PyTorch port)")
    ap.add_argument("--params", default=None, help=f"npz weights (default {DEFAULT_PARAMS}; "
                    "under --smoke the seeded init unless given)")
    ap.add_argument("--eval-images", type=int, default=32)
    ap.add_argument("--instances", type=int, nargs=2, default=(20, 30),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--dets-per-class", type=int, nargs="*", default=(16, 64, 100))
    ap.add_argument("--vote-top-k", type=int, nargs="*", default=(64, 0),
                    help="0 = all candidates (reference behavior)")
    ap.add_argument("--only", default=None,
                    help="single 'dets,votek' config per process")
    ap.add_argument("--pre-nms", type=int, default=1024)
    ap.add_argument("--mask-size", type=int, default=21,
                    help="MASK_SIZE the checkpoint was trained with (28 for "
                         "the mnc_5stage_best recipe)")
    ap.add_argument("--anchor-scales", type=int, nargs="*", default=None,
                    help="must match the --params checkpoint's anchors "
                         "(default (8,16,32))")
    ap.add_argument("--append", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny arch + seeded random params (plumbing check)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.eval_images = min(args.eval_images, 4)
    return args


def build_arch(args):
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.tools.ablation_study import smoke_arch

    if args.smoke:
        return smoke_arch()
    return MNCArch(canvas=(640, 1024), anchor_scales=tuple(args.anchor_scales or (8, 16, 32)),
                   num_classes=6, mask_size=args.mask_size, warp_hw=14, n_stages=5,
                   fc_dim=4096, mask_fc_dim=256, pre_nms_top_n=args.pre_nms,
                   post_nms_top_n=304, rpn_min_size=16.0, trunk_frozen=0)


def load_model(arch, params_path, device, smoke: bool):
    """The model of ``arch`` on ``device``: the npz's weights (read once),
    or under ``smoke`` without one the seeded random init."""
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.utils.checkpoint import load_npz, state_dict_from_jax

    if smoke and params_path is None:
        return MNC(arch, device=device, seed=0)
    model = MNC(arch, device=device, seed=None)  # no random init: every weight is loaded
    model.load_state_dict(state_dict_from_jax(load_npz(params_path or DEFAULT_PARAMS)[0]))
    return model


def crowd_val(arch, args):
    """The crowded validation set: (imdb, [(id, example)], gt)."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

    lo, hi = args.instances
    val = SyntheticIMDB(canvas_hw=arch.canvas, num_classes=arch.num_classes, max_gt=hi,
                        gt_mask_size=28, n_range=(lo, hi), num_images=args.eval_images,
                        seed=202)
    return val, [(i, val.example(i)) for i in val.image_index], val.gt_instances()


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.data.eval_sds import eval_sds
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg
    from mnc_tpu_torch.tools.ablation_study import detect_all
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    arch = build_arch(args)
    model = load_model(arch, args.params, device, args.smoke)
    val, val_ex, gt = crowd_val(arch, args)
    n_gt = sum(len(v) for v in gt.values())
    print(f"crowd val: {len(val_ex)} images, {n_gt} instances "
          f"({n_gt / len(val_ex):.1f}/image)", flush=True)

    configs = [(d, k) for d in args.dets_per_class for k in args.vote_top_k]
    if args.only:
        d, k = (int(x) for x in args.only.split(","))
        configs = [(d, k)]

    results = []
    for dets_pc, vote_k in configs:
        post = PostCfg(dets_per_class=dets_pc, max_per_image=100,
                       vote_top_k=(vote_k if vote_k > 0 else 10**9), score_thresh=0.01)
        dets, t_det = detect_all(MNCPipeline(model, post), val_ex, device)
        # does the per-class cap bind?  Below dets_per_class in every
        # (image, class) cell, it truncated nothing at this density
        cell = Counter((d["image_id"], d["class_id"]) for d in dets)
        rec = {
            "config": f"dets_per_class={dets_pc},vote_top_k={vote_k or 'all'}",
            "max_dets_per_image_class": max(cell.values()) if cell else 0,
            "instances_per_image": round(n_gt / len(val_ex), 1),
            "map_r_050": round(eval_sds(dets, gt, val.num_classes, 0.5)["map"], 4),
            "map_r_070": round(eval_sds(dets, gt, val.num_classes, 0.7)["map"], 4),
            "ms_per_img": round(t_det / len(val_ex) * 1e3, 1),
            "n_images": len(val_ex),
        }
        print(json.dumps(rec), flush=True)
        if args.append:
            with open(args.append, "a") as f:
                f.write(json.dumps(rec) + "\n")
        results.append(rec)

    print("\nsummary:")
    for r in results:
        print(f"  {r['config']:<36} mAP^r .5/.7 = {r['map_r_050']:.3f}/"
              f"{r['map_r_070']:.3f}  {r['ms_per_img']:.0f} ms/img")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
