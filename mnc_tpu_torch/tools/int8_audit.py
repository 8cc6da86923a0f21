"""Per-stage int8-against-float audit of ``TEST.INT8`` — the port's
counterpart of ``tools/int8_audit.py``.

Builds the cascade of the cfg (``--cfg`` / ``--set``) twice on the same
weights, once in its float compute dtype and once with ``int8_inference``,
and measures where the quantization error enters, image by image of a
synthetic imdb (the JAX tool's, seed 123):

  1. trunk features      — int8 against float convolutions, same image:
                           mean |Δ| / mean |float features|
  2. rpn logits          — each head on its own trunk's features: max |Δ|
  3. proposal agreement  — the best IoU of each int8 RoI against the float
                           RoI set, and the share of RoIs whose best IoU
                           exceeds 0.999
  4. head isolation      — int8 heads against float heads on IDENTICAL
                           float features and RoIs: |Δ cls_prob| and
                           |Δ sigmoid(mask)| over the valid RoIs
  5. end-to-end          — each cascade on its own proposals: |Δ cls_prob|
                           and |Δ sigmoid(mask)| where both RoIs are valid

Distributions are p50/p95/max over images × RoIs, printed as one JSON line
with the JAX tool's keys.  Images run one at a time, as the JAX tool's
unbatched ``apply`` does (the activation scales cover one canvas).

    python3 -m mnc_tpu_torch.tools.int8_audit [--params P.npz | --seed 0] \\
        [--images 16] [--cfg FILE] [--set KEY VAL ...] [--device cpu]

``--params`` reads an npz that the JAX package's ``save_npz`` (or the
port's ``train_net``) wrote; without it the weights are the seeded random
init.  It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def pct(x, q):
    return round(float(np.percentile(np.asarray(x, np.float64), q)), 6)


def dist(x):
    return {"p50": pct(x, 50), "p95": pct(x, 95), "max": round(float(np.max(x)), 6)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="int8 against float, stage by stage")
    ap.add_argument("--params", default=None, help="npz of weights (save_npz layout)")
    ap.add_argument("--seed", type=int, default=0, help="random init without --params")
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_models(arch, device, params_path=None, seed=0):
    """The float and the int8 cascade of ``arch`` on the same weights."""
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.utils.checkpoint import load_import_weights, state_dict_from_jax

    params = None
    if params_path:
        params, arch = load_import_weights(None, params_path, arch, None)
    models = []
    for q in (False, True):
        m = MNC(dataclasses.replace(arch, int8_inference=q), device=device, seed=seed)
        if params is not None:
            m.load_state_dict(state_dict_from_jax(params))
        models.append(m)
    return models


def audit(m_fp, m_i8, images, infos) -> dict:
    """The JSON record of the audit over (H, W, 3) canvases and (3,) im_infos."""
    import torch

    from mnc_tpu_torch.ops.bbox import bbox_overlaps

    dev = m_fp.device

    def heads(model, feat, rois):
        rf = model.warp(feat, rois[None])[0]
        ml = model.mask_stage(rf)
        cl, _ = model.classify_stage(rf, ml)
        return ml, torch.softmax(cl, -1)

    def host(t):
        return t.float().cpu().numpy()

    def sig(x):
        return 1 / (1 + np.exp(-x))

    feat_rel, rpn_abs, roi_iou, roi_same = [], [], [], []
    hd_cls, hd_mask, e2e_cls, e2e_mask = [], [], [], []
    with torch.inference_mode():
        for img, info in zip(images, infos):
            img = torch.as_tensor(img, device=dev)[None]
            info = torch.as_tensor(info, device=dev)
            fb, f8 = m_fp.features(img), m_i8.features(img)
            fbn, f8n = host(fb), host(f8)
            feat_rel.append(np.abs(f8n - fbn).mean() / (np.abs(fbn).mean() + 1e-9))
            # the rpn head is float in both paths: how much trunk error survives it
            cb_r, _ = m_fp.rpn(fb)
            c8_r, _ = m_i8.rpn(f8)
            rpn_abs.append(float(np.abs(host(c8_r) - host(cb_r)).max()))

            ob, o8 = m_fp(img[0], info), m_i8(img[0], info)
            vb, v8 = ob["roi_valid"].cpu().numpy(), o8["roi_valid"].cpu().numpy()
            rb, r8 = ob["rois"][ob["roi_valid"]], o8["rois"][o8["roi_valid"]]
            if len(rb) and len(r8):
                best = host(bbox_overlaps(r8.float(), rb.float())).max(1)
                roi_iou.extend(best.tolist())
                roi_same.append(float((best > 0.999).mean()))
            # head isolation: identical float features and rois
            mb, cb = heads(m_fp, fb, ob["rois"])
            m8, c8 = heads(m_i8, fb, ob["rois"])
            hd_cls.extend(np.abs(host(c8) - host(cb))[vb].ravel())
            hd_mask.extend(np.abs(sig(host(m8)) - sig(host(mb)))[vb].ravel())
            both = v8 & vb
            e2e_cls.append(np.abs(host(o8["cls_prob"]) - host(ob["cls_prob"]))[both].ravel())
            e2e_mask.append(np.abs(sig(host(o8["mask_logits"]))
                                   - sig(host(ob["mask_logits"])))[both].ravel())
    return {
        "metric": "int8_stage_audit",
        "n_images": len(images),
        "mask_size": m_fp.arch.mask_size,
        "trunk_feat_rel_err": dist(feat_rel),
        "rpn_logit_absdiff_max": dist(rpn_abs),
        "proposal_best_iou": dist(roi_iou),
        "proposal_identical_frac": round(float(np.mean(roi_same)), 4),
        "heads_only_cls_prob_absdiff": dist(np.asarray(hd_cls)),
        "heads_only_mask_prob_absdiff": dist(np.asarray(hd_mask)),
        "e2e_cls_prob_absdiff": dist(np.concatenate(e2e_cls)),
        "e2e_mask_prob_absdiff": dist(np.concatenate(e2e_mask)),
    }


def synthetic_images(arch, n):
    """The JAX tool's validation images (canvases, im_infos) on the canvas
    of ``arch``, drawn with its classes (at most the 5 shapes and the
    background)."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
    from mnc_tpu_torch.data.synthetic import SHAPE_NAMES

    val = SyntheticIMDB(canvas_hw=arch.canvas,
                        num_classes=min(arch.num_classes, len(SHAPE_NAMES) + 1), max_gt=6,
                        gt_mask_size=28, num_images=n, seed=123)
    exs = [val.example(i) for i in val.image_index]
    return [e["image"] for e in exs], [e["im_info"] for e in exs]


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.config import cfg_from_file, cfg_from_list
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    arch = MNCArch.from_cfg(train=False)
    m_fp, m_i8 = build_models(arch, device, args.params, args.seed)
    rec = audit(m_fp, m_i8, *synthetic_images(arch, args.images))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
