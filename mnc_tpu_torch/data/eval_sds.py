"""mAP^r evaluation — the SDS protocol (Hariharan et al.): the port's own
copy of ``mnc_tpu/data/eval_sds.py``.

Behavioral port of the reference ``lib/datasets/voc_eval_sds.py``: per class,
rank all detections by score across the dataset, greedily match each to the
highest-mask-IoU unclaimed ground-truth instance of the same class in its
image (match iff IoU ≥ threshold), build the precision/recall curve, and
report VOC-style average precision; mAP^r is the class mean.  The reference
reported mAP^r @0.5 and @0.7 on VOC 2012 SBD val.

Detections and ground truth are exchanged in a dataset-agnostic dict format
so the evaluator serves PASCAL/SBD, COCO and the synthetic dataset alike:

    det  = {image_id, class_id, score, mask (binary, full canvas or
            box-cropped + box)}
    gt   = per image: list of {class_id, mask}

Mask IoU is computed by the port's compiled host helper
(``mnc_tpu_torch.native.mask_iou_matrix``, popcounts of bit-packed masks),
where the JAX package calls its own.
"""

from __future__ import annotations

import numpy as np

from mnc_tpu_torch.native import mask_iou_matrix  # noqa: F401  (the evaluator's)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two aligned binary masks."""
    a = a > 0.5
    b = b > 0.5
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP: 11-point (2007) or continuous (2010+, the SDS setting)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_sds(
    detections: list[dict],
    gt_instances: dict,
    num_classes: int,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> dict:
    """Compute per-class AP^r and mAP^r.

    Args:
      detections: list of dicts with keys image_id, class_id, score,
        mask (binary np array in canvas space — must align with gt masks).
      gt_instances: {image_id: list of {"class_id": int, "mask": np.ndarray}}.
      num_classes: total classes including background (class 0 ignored).
      iou_thresh: mask-IoU match threshold (0.5 / 0.7).

    Returns {"ap": {class_id: AP}, "map": float, "thresh": iou_thresh}.
    """
    ap = {}
    for cls in range(1, num_classes):
        dets_c = [d for d in detections if d["class_id"] == cls]
        dets_c.sort(key=lambda d: -d["score"])

        # gather gt of this class per image
        gts_c = {
            img: [g for g in lst if g["class_id"] == cls]
            for img, lst in gt_instances.items()
        }
        npos = sum(len(v) for v in gts_c.values())
        if npos == 0:
            continue
        claimed = {img: np.zeros(len(v), bool) for img, v in gts_c.items()}

        # det×gt mask-IoU matrices per image, one call each — the evaluator hot loop.
        by_img: dict = {}
        for i, det in enumerate(dets_c):
            by_img.setdefault(det["image_id"], []).append(i)
        iou_of: dict = {}
        for img, det_ids in by_img.items():
            gts = gts_c.get(img, [])
            if not gts:
                continue
            dmasks = np.stack([dets_c[i]["mask"] for i in det_ids])
            gmasks = np.stack([g["mask"] for g in gts])
            mat = mask_iou_matrix(dmasks, gmasks)
            for row, i in enumerate(det_ids):
                iou_of[i] = mat[row]

        tp = np.zeros(len(dets_c))
        fp = np.zeros(len(dets_c))
        for i, det in enumerate(dets_c):
            img = det["image_id"]
            ious = iou_of.get(i)
            if ious is None or ious.size == 0:
                fp[i] = 1
                continue
            best_j = int(np.argmax(ious))
            if ious[best_j] >= iou_thresh and not claimed[img][best_j]:
                tp[i] = 1
                claimed[img][best_j] = True
            else:
                fp[i] = 1

        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        rec = tp_cum / npos
        prec = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
        ap[cls] = voc_ap(rec, prec, use_07_metric)

    mean_ap = float(np.mean(list(ap.values()))) if ap else 0.0
    return {"ap": ap, "map": mean_ap, "thresh": iou_thresh}


def eval_sds_matches(
    detections: list[dict],
    gt_instances: dict,
    num_classes: int,
    iou_thresh: float = 0.5,
) -> dict:
    """Per-image decomposition of :func:`eval_sds` for paired bootstrap.

    Greedy matching claims gt per image, and detections of different images
    never compete, so matching each image's detections in descending-score
    order is EXACTLY the global-rank greedy restricted to that image.  The
    per-image (scores, tp) lists therefore recompose to the full eval under
    any image resampling — the basis for image-level bootstrap CIs
    (:func:`map_from_matches`).

    Returns {cls: {"npos": {img: int}, "scores": {img: f64[n]},
                   "tp": {img: bool[n]}}} (images with no dets/gt omitted
    from the respective dicts).
    """
    out: dict = {}
    for cls in range(1, num_classes):
        npos: dict = {}
        scores: dict = {}
        tps: dict = {}
        for img, lst in gt_instances.items():
            n = sum(1 for g in lst if g["class_id"] == cls)
            if n:
                npos[img] = n
        by_img: dict = {}
        for d in detections:
            if d["class_id"] == cls:
                by_img.setdefault(d["image_id"], []).append(d)
        for img, dets in by_img.items():
            dets.sort(key=lambda d: -d["score"])
            gts = [g for g in gt_instances.get(img, ())
                   if g["class_id"] == cls]
            tp = np.zeros(len(dets), bool)
            if gts:
                dmasks = np.stack([d["mask"] for d in dets])
                gmasks = np.stack([g["mask"] for g in gts])
                mat = mask_iou_matrix(dmasks, gmasks)
                claimed = np.zeros(len(gts), bool)
                for i in range(len(dets)):
                    j = int(np.argmax(mat[i]))
                    if mat[i, j] >= iou_thresh and not claimed[j]:
                        tp[i] = True
                        claimed[j] = True
            scores[img] = np.array([d["score"] for d in dets], np.float64)
            tps[img] = tp
        if npos:
            out[cls] = {"npos": npos, "scores": scores, "tp": tps}
    return out


def map_from_matches(matches: dict, image_ids,
                     use_07_metric: bool = False) -> float:
    """mAP^r over an image multiset (with multiplicity) from
    :func:`eval_sds_matches` output.  With each image once, equals
    ``eval_sds(...)["map"]``."""
    from collections import Counter

    mult = Counter(image_ids)
    aps = []
    for cls, m in matches.items():
        npos = sum(n * mult.get(img, 0) for img, n in m["npos"].items())
        if npos == 0:
            continue
        sc_parts, tp_parts = [], []
        for img, k in mult.items():
            s = m["scores"].get(img)
            if s is None or k == 0:
                continue
            sc_parts.append(np.tile(s, k))
            tp_parts.append(np.tile(m["tp"][img], k))
        if not sc_parts:
            aps.append(0.0)
            continue
        sc = np.concatenate(sc_parts)
        tp = np.concatenate(tp_parts).astype(np.float64)
        order = np.argsort(-sc, kind="stable")
        tp = tp[order]
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(1.0 - tp)
        rec = tp_cum / npos
        prec = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
        aps.append(voc_ap(rec, prec, use_07_metric))
    return float(np.mean(aps)) if aps else 0.0


def bootstrap_map_ci(matches: dict, image_ids, n_boot: int = 1000,
                     seed: int = 0, alpha: float = 0.05,
                     resamples: np.ndarray | None = None):
    """Image-level bootstrap of mAP^r.  Returns (maps[n_boot], (lo, hi)).

    Pass the same ``resamples`` (n_boot, n_images) index array to every
    variant for PAIRED deltas (CI of map_A - map_B over shared resamples).
    """
    ids = list(image_ids)
    if resamples is None:
        rs = np.random.RandomState(seed)
        resamples = rs.randint(0, len(ids), size=(n_boot, len(ids)))
    maps = np.array([
        map_from_matches(matches, [ids[j] for j in row])
        for row in resamples])
    lo, hi = np.percentile(maps, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return maps, (float(lo), float(hi))


def collect_detections(det_out: dict, image_id, score_thresh: float = 0.0) -> list[dict]:
    """Flatten one image's pipeline output (MNCPipeline.detect[_canvas] dict,
    already on host) into evaluator det records using canvas/full masks."""
    masks = det_out.get("canvas_masks", det_out.get("full_masks"))
    assert masks is not None, "postprocess must produce pasted masks for eval"
    recs = []
    for k in range(len(det_out["scores"])):
        if not det_out["valid"][k] or det_out["scores"][k] < score_thresh:
            continue
        recs.append({
            "image_id": image_id,
            "class_id": int(det_out["classes"][k]),
            "score": float(det_out["scores"][k]),
            "mask": np.asarray(masks[k]),
        })
    return recs


def print_ap_table(result: dict, class_names=None) -> str:
    """Render the per-class AP table in the reference's printed format."""
    t = result["thresh"]
    t = f"{t:.1f}" if isinstance(t, float) else t
    lines = [f"~~~~~~ Evaluation: mAP^r @ IoU {t} ~~~~~~"]
    for cls, val in sorted(result["ap"].items()):
        name = class_names[cls] if class_names else f"class_{cls:02d}"
        lines.append(f"AP for {name} = {val:.4f}")
    lines.append(f"Mean AP^r = {result['map']:.4f}")
    return "\n".join(lines)


def eval_sds_averaged(
    detections: list[dict],
    gt_instances: dict,
    num_classes: int,
    thresholds=None,
    use_07_metric: bool = False,
) -> dict:
    """COCO-style averaged-threshold region AP: AP^r@[.5:.95].

    Runs the SDS matcher at each IoU threshold (default 0.5:0.05:0.95, the
    COCO convention) and averages per class — the stretch-config metric
    (BASELINE configs[4]; the reference reported COCO seg AP@[.5:.95] for its
    challenge entry).

    Returns {"ap": {cls: averaged AP}, "map": float, "thresh": "0.50:0.95",
             "per_thresh": {t: mAP at t}}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 0.951, 0.05)
    thresholds = [round(float(t), 2) for t in thresholds]
    results = {
        t: eval_sds(detections, gt_instances, num_classes, iou_thresh=t,
                    use_07_metric=use_07_metric)
        for t in thresholds
    }
    classes = set()
    for r in results.values():
        classes.update(r["ap"])
    ap = {
        cls: float(np.mean([results[t]["ap"].get(cls, 0.0) for t in thresholds]))
        for cls in sorted(classes)
    }
    mean_ap = float(np.mean(list(ap.values()))) if ap else 0.0
    return {"ap": ap, "map": mean_ap, "thresh": "0.50:0.95",
            "per_thresh": {t: results[t]["map"] for t in thresholds}}
