"""The comparison that decides ``correct``: what the timed path produced for
a sample of its requests, against the plain float32 reference.

The cascade selects at four places (the proposals, the bridge's class, the
per-class NMS and top-K, the voting candidates), and with random weights a
selection flips on rounding.  So the reference follows the program step by
step: it replays each selection from the program's own values and must
reproduce what the program selected bit for bit, and it computes the values
afresh in float32 from the canvases and the weights, at the RoIs and
detections the program selected.  Two numbers come out of a sample:

- ``model_rel``: the network's values.  For each output kind (the RPN's
  logits and deltas; the mask logits, class logits and box deltas of each
  head pass) the relative L2 error of the program's outputs against the
  reference's over the sampled requests, at the program's RoIs; then the
  root mean square over the kinds.  The trunk, the RPN head, the RoI warp
  and both heads.  Infinite where a replay differs: the proposals from the
  program's RPN outputs, the bridge from its first pass, or the cascade's
  class probabilities and mask logits from its head outputs.
- ``mask_diff``: the served masks.  The share of the canvas-mask pixels set
  in either that differ between the served bit-packed masks and the
  reference's: its soft masks at the program's second-pass RoIs, voted
  over the served candidates with the program's class probabilities as
  weights (checked by ``model_rel``), pasted into the served boxes and
  thresholded.  Voting, kernel C and the packing.  Infinite where the
  replayed post-processing differs from the served boxes, classes, scores
  or validity.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import mnc as ref

NUMBERS = ("model_rel", "mask_diff")


def _sq(got, want) -> tuple[float, float]:
    """(squared L2 of the difference, squared L2 of ``want``), in float64."""
    got, want = got.double(), want.double()
    return (torch.linalg.vector_norm(got - want).item() ** 2,
            torch.linalg.vector_norm(want).item() ** 2)


class Reference:
    """The reference's constants for a configuration and its float32 weights."""

    def __init__(self, weights: dict, net: dict, post: dict, device):
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
        self.net, self.post, self.device = net, post, device
        fh, fw = (s // net["feat_stride"] for s in net["canvas"])
        a = ref.all_anchors((fh, fw), net["feat_stride"], net["anchor_ratios"],
                            net["anchor_scales"])
        na = len(net["anchor_scales"]) * len(net["anchor_ratios"])
        self.anchors = torch.from_numpy(a).to(device)
        self.trainable = torch.from_numpy(ref.trainable_anchors(a, net["canvas"], na)).to(device)
        self.resize = torch.from_numpy(ref.resize_matrix(net["mask_size"], net["warp_hw"])).to(
            device)


@torch.inference_mode()
def compare_request(r: Reference, canvases, im_info, cap: dict) -> dict:
    """The numbers' parts for one served request: ``cap`` holds what the
    program produced (``rpn``: its RPN outputs; ``mask``, ``cls``: its head
    outputs, pass by pass; ``net``: the cascade's outputs; ``out``: the
    served detections)."""
    net, post = r.net, r.post
    canvases, im_info = canvases.to(r.device), im_info.to(r.device)
    b = canvases.shape[0]
    n, c, m = net["post_nms_top_n"], net["num_classes"], net["mask_size"]
    prog, out = cap["net"], cap["out"]
    five = net["n_stages"] == 5

    feat = ref.trunk(r.w, canvases, net)
    r_cls, r_box = ref.rpn(r.w, feat)
    p_cls, p_box = cap["rpn"]
    kinds = {"rpn_cls": _sq(p_cls, r_cls), "rpn_box": _sq(p_box, r_box)}
    rois_r, valid_r, _ = ref.propose(p_cls.float(), p_box.float(), im_info, r.anchors,
                                     r.trainable, net)
    replayed = (torch.equal(rois_r, prog["stage3_rois"])
                and torch.equal(valid_r, prog["roi_valid"]))

    rois1, rois2 = prog["stage3_rois"], prog["rois"]
    passes = [ref.heads(r.w, feat, rois1, net, r.resize)]
    if five:
        passes.append(ref.heads(r.w, feat, rois2, net, r.resize))
    for i, (rm, rc, rb) in enumerate(passes):
        pm, (pc, pb) = cap["mask"][i], cap["cls"][i]
        kinds.update({f"mask{i}": _sq(pm, rm), f"cls{i}": _sq(pc, rc), f"box{i}": _sq(pb, rb)})
    probs = [torch.softmax(pc, dim=-1).reshape(b, n, c) for _, (pc, _) in zip(passes, cap["cls"])]
    replayed = (replayed and torch.equal(probs[0], prog["stage3_cls_prob"])
                and torch.equal(cap["mask"][0].reshape(b, n, m, m), prog["stage3_mask_logits"])
                and torch.equal(cap["mask"][-1].reshape(b, n, m, m), prog["mask_logits"]))
    if five:
        bridged, _ = ref.bridge(rois1, probs[0], cap["cls"][0][1].reshape(b, n, -1), im_info, net)
        replayed = (replayed and torch.equal(bridged, rois2)
                    and torch.equal(0.5 * (probs[0] + probs[1]), prog["cls_prob"]))

    sel = ref.select_detections(rois2, prog["roi_valid"], prog["cls_prob"], post)
    served = all(torch.equal(sel[k], out[k]) for k in ("boxes", "scores", "classes", "valid"))
    _, canvas_ref = ref.detection_masks(sel, rois2, passes[-1][0].reshape(b, n, m, m),
                                        sel["cand_scores"], tuple(net["canvas"]), post)
    bits = ref.unpack_bits(out["canvas_masks"], net["canvas"][1])
    v = sel["valid"][..., None, None]
    return {"kinds": kinds, "replayed": replayed, "served": served,
            "mask_differ": ((bits ^ canvas_ref) & v).sum().item(),
            "mask_union": ((bits | canvas_ref) & v).sum().item(),
            "dets": int(sel["valid"].sum().item())}


def combine(parts: list) -> dict:
    """The numbers over every request compared."""
    if not parts:
        return {k: math.inf for k in NUMBERS}
    rels = []
    for kind in parts[0]["kinds"]:
        diff = sum(p["kinds"][kind][0] for p in parts)
        ref_sq = sum(p["kinds"][kind][1] for p in parts)
        rels.append(diff / max(ref_sq, 1e-300))
    model_rel = math.sqrt(sum(rels) / len(rels))
    union = sum(p["mask_union"] for p in parts)
    mask_diff = sum(p["mask_differ"] for p in parts) / union if union else math.inf
    return {"model_rel": model_rel if all(p["replayed"] for p in parts) else math.inf,
            "mask_diff": mask_diff if all(p["served"] for p in parts) else math.inf}


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
