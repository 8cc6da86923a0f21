"""The plain reference of the 5-stage MNC serving path, in float32 PyTorch.

A frozen copy of the arithmetic of the port's plain versions (trunk, RPN,
proposals, RoI warp, mask and classify heads, the per-RoI conv5 head, the
stage bridge, per-class NMS, mask voting, the paste and the bit packing),
written as functions of a state dict of float32 tensors under the port's
parameter names.  It imports nothing of the port: the benchmark holds the
port against it.  Each stage that makes a selection (the proposals, the
bridge's class, the per-class NMS and top-K, the voting candidates) also
returns what it selected, so that the check can replay the program's
selections from the program's own values and then weigh them with the
reference's values.

Tensors are NHWC, as the port's public layout; a batch of canvases is
(B, H, W, 3) uint8 with im_info (B, 3) = (scaled h, scaled w, scale).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_MEANS = (102.9801, 115.9465, 122.7717)  # BGR
RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
VGG16_BLOCKS = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"),
                ("conv3_1", "conv3_2", "conv3_3"), ("conv4_1", "conv4_2", "conv4_3"),
                ("conv5_1", "conv5_2", "conv5_3"))


# --------------------------------------------------------------------------- #
# Geometry: anchors, boxes, NMS
# --------------------------------------------------------------------------- #


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def _whctrs(a):
    w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
    return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)


def base_anchors(stride: int, ratios, scales) -> np.ndarray:
    """py-faster-rcnn's generate_anchors: ratios × scales of a stride box."""
    w, h, xc, yc = _whctrs(np.array([0, 0, stride - 1, stride - 1], np.float64))
    size_ratios = w * h / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    ratio_anchors = _mkanchors(ws, np.round(ws * np.asarray(ratios)), xc, yc)
    out = []
    for a in ratio_anchors:
        w, h, xc, yc = _whctrs(a)
        s = np.asarray(scales, np.float64)
        out.append(_mkanchors(w * s, h * s, xc, yc))
    return np.vstack(out).astype(np.float32)


def all_anchors(feat_hw, stride, ratios, scales) -> np.ndarray:
    """(Hf·Wf·A, 4) anchors, row-major over (y, x, anchor)."""
    base = base_anchors(stride, ratios, scales)
    sx, sy = np.meshgrid(np.arange(feat_hw[1]) * stride, np.arange(feat_hw[0]) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1).astype(np.float32)
    return (base[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32)


def trainable_anchors(anchors: np.ndarray, canvas_hw, num_anchors: int) -> np.ndarray:
    """False for anchor types with no fully-inside position on the canvas."""
    h, w = canvas_hw
    a = anchors
    inside = (a[:, 0] >= 0) & (a[:, 1] >= 0) & (a[:, 2] < w) & (a[:, 3] < h)
    return np.tile(inside.reshape(-1, num_anchors).any(0), a.shape[0] // num_anchors)


def decode(boxes, deltas):
    """Regression deltas applied to (..., 4) boxes (+1 widths, dw/dh at ±8)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas.unbind(-1)
    lim = deltas.new_full((), 8.0)
    dw = torch.minimum(torch.maximum(dw, -lim), lim)
    dh = torch.minimum(torch.maximum(dh, -lim), lim)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw - 1.0,
                        pcy + 0.5 * ph - 1.0], -1)


def clip(boxes, h, w):
    """x into [0, w-1], y into [0, h-1]; h, w broadcast against boxes[..., 0]."""
    zero = boxes.new_zeros(())

    def c(v, hi):
        return torch.minimum(torch.maximum(v, zero), torch.as_tensor(
            hi - 1.0, dtype=boxes.dtype, device=boxes.device))
    return torch.stack([c(boxes[..., 0], w), c(boxes[..., 1], h),
                        c(boxes[..., 2], w), c(boxes[..., 3], h)], -1)


def overlaps(a, b):
    """Pairwise IoU (..., N, K) with +1 widths and the union at least 1."""
    a, q = a.unsqueeze(-2), b.unsqueeze(-3)
    iw = (torch.minimum(a[..., 2], q[..., 2]) - torch.maximum(a[..., 0], q[..., 0]) + 1.0)
    ih = (torch.minimum(a[..., 3], q[..., 3]) - torch.maximum(a[..., 1], q[..., 1]) + 1.0)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)

    def area(x):
        return (x[..., 2] - x[..., 0] + 1.0) * (x[..., 3] - x[..., 1] + 1.0)
    union = area(a) + area(q) - inter
    return inter / union.clamp_min(1.0)


def take_rows(x, idx):
    """x (B, K, ...) indexed per batch row by idx (B, ...)."""
    bidx = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[bidx, idx]


def greedy_keep(boxes, valid, thresh: float):
    """Greedy NMS over score-sorted (P, K, 4) boxes: keep[j] = valid[j] and no
    kept i < j overlaps j by more than ``thresh`` (the fixpoint, iterated)."""
    k = boxes.shape[-2]
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (overlaps(boxes, boxes) > float(np.float32(thresh))) & upper & valid.unsqueeze(-1)
    keep = valid.clone()
    for _ in range(k):
        new = valid & ~(keep.unsqueeze(-1) & sup).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_top(boxes, scores, valid, thresh: float, top_n: int, presorted: bool = False):
    """Sort by score (stable), greedy NMS, the first ``top_n`` keeps in score
    order: (idx, keep_valid), idx into the unsorted set, padding = idx[..., 0]."""
    k = boxes.shape[-2]
    if presorted:
        order, sb, sv = None, boxes, valid
    else:
        neg = torch.finfo(scores.dtype).min
        order = torch.sort(-torch.where(valid, scores, torch.full_like(scores, neg)),
                           dim=-1, stable=True).indices
        sb = torch.gather(boxes, -2, order.unsqueeze(-1).expand(*order.shape, 4))
        sv = torch.gather(valid, -1, order)
    keep = greedy_keep(sb.reshape(-1, k, 4), sv.reshape(-1, k), thresh).reshape(sv.shape)
    rank = torch.arange(k, device=boxes.device)
    top = torch.sort(torch.where(keep, rank, rank + k), dim=-1, stable=True).indices[..., :top_n]
    kv = torch.gather(keep, -1, top)
    idx = top if order is None else torch.gather(order, -1, top)
    return torch.where(kv, idx, idx[..., :1]), kv


# --------------------------------------------------------------------------- #
# Resampling: RoI warp, mask resize, voting frames, paste
# --------------------------------------------------------------------------- #


def _unit_grid(n: int, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i + 0.5) / torch.full_like(i, float(n))


def hats(centers, size: int):
    """Bilinear hat weights (..., P, S) of coordinates (..., P)."""
    d = centers.unsqueeze(-1) - torch.arange(size, dtype=torch.float32, device=centers.device)
    return (1.0 - d.abs()).clamp_min(0.0)


def roi_warp(feat, rois, out: int, scale: float):
    """Bilinear crop-and-resize: feat (B, H, W, C), rois (B, N, 4) →
    (B, N, out, out, C); bin centers at lo·s + (i + 0.5)·span·s/out − 0.5."""
    _, h, w, _ = feat.shape
    g = _unit_grid(out, rois.device)

    def centers(lo, hi):
        return lo.unsqueeze(-1) * scale + g * ((hi - lo + 1.0) * scale).unsqueeze(-1) - 0.5
    wy = hats(centers(rois[..., 1], rois[..., 3]), h)  # (B, N, P, H)
    wx = hats(centers(rois[..., 0], rois[..., 2]), w)  # (B, N, Q, W)
    tmp = torch.einsum("bnqw,bhwc->bnhqc", wx, feat)
    return torch.einsum("bnph,bnhqc->bnpqc", wy, tmp)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(out, in) weights of an antialiased linear resize (triangle kernel
    widened by in/out when shrinking, each output's weights normalized)."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    ks = f32(max(inv, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / ks
    wgt = np.maximum(f32(0.0), f32(1.0) - x)
    tot = wgt.sum(0, keepdims=True)
    wgt = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                   wgt / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wgt, f32(0.0)).T.astype(np.float32)


def vote_masks(kept, cand_boxes, cand_scores, cand_masks, iou_thresh: float):
    """Score-weighted average of the candidates' soft masks that overlap each
    kept box by ≥ ``iou_thresh``, each resampled from its own box frame into
    the kept box's: kept (N, 4), candidates (N, V, ...) → (N, M, M)."""
    m = cand_masks.shape[-1]
    iou = overlaps(kept.unsqueeze(-2), cand_boxes).squeeze(-2)
    w = torch.where(iou >= iou_thresh, cand_scores, torch.zeros((), device=iou.device))
    grid = (torch.arange(m, dtype=torch.float32, device=kept.device) + 0.5) / m
    dst = kept.unsqueeze(1).expand_as(cand_boxes)

    def coords(lo_d, hi_d, lo_s, hi_s):
        img = lo_d.unsqueeze(-1) + grid * (hi_d - lo_d + 1.0).unsqueeze(-1)
        return ((img - lo_s.unsqueeze(-1)) / (hi_s - lo_s + 1.0).clamp_min(1.0).unsqueeze(-1)
                * m - 0.5)
    wy = hats(coords(dst[..., 1], dst[..., 3], cand_boxes[..., 1], cand_boxes[..., 3]), m)
    wx = hats(coords(dst[..., 0], dst[..., 2], cand_boxes[..., 0], cand_boxes[..., 2]), m)
    stacks = wy @ cand_masks @ wx.transpose(-1, -2)
    return torch.einsum("nc,ncpq->npq", w, stacks) / w.sum(1).clamp_min(1e-8)[:, None, None]


def _paste_weights(lo, hi, m: int, n: int):
    """(..., n, M) hats that spread M mask samples over pixels [0, n) of a box
    spanning [lo, hi]; a pixel inside the box beyond the outer sample centers
    takes the nearest sample."""
    pix = torch.arange(n, dtype=torch.float32, device=lo.device)
    t = (pix - lo.unsqueeze(-1) + 0.5) / (hi - lo + 1.0).unsqueeze(-1)
    coord = t * m - 0.5
    wm = hats(coord, m)
    inside = (t >= 0.0) & (t < 1.0)
    edge = (coord.unsqueeze(-1) - torch.arange(m, dtype=torch.float32, device=lo.device)
            ).abs().argmin(-1)
    wm = torch.where((wm.sum(-1, keepdim=True) > 0.0) | ~inside.unsqueeze(-1), wm,
                     F.one_hot(edge, m).to(torch.float32))
    return wm * inside.unsqueeze(-1).to(torch.float32)


def paste(masks, boxes, canvas_hw, thresh: float):
    """Soft masks (N, M, M) in box frames → bool canvases (N, H, W)."""
    h, w = canvas_hw
    m = masks.shape[-1]
    wy = _paste_weights(boxes[:, 1], boxes[:, 3], m, h)
    wx = _paste_weights(boxes[:, 0], boxes[:, 2], m, w)
    return (wy @ masks @ wx.transpose(1, 2)) > thresh


def pack_bits(masks):
    """np.packbits along the last axis: 8 pixels a byte, the first high."""
    x = F.pad(masks.to(torch.uint8), (0, (-masks.shape[-1]) % 8))
    x = x.reshape(*x.shape[:-1], -1, 8).to(torch.int32)
    return (x << torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)).sum(-1).to(
        torch.uint8)


def unpack_bits(packed, width: int):
    """Inverse of :func:`pack_bits`: (..., W/8) uint8 → (..., width) bool."""
    bits = (packed.to(torch.int32).unsqueeze(-1)
            >> torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].bool()


# --------------------------------------------------------------------------- #
# The network, as functions of a float32 state dict
# --------------------------------------------------------------------------- #


def _conv(x, w, name, stride=1, bias=True):
    k = w[f"{name}.weight"].shape[-1]
    return F.conv2d(x, w[f"{name}.weight"], w[f"{name}.bias"] if bias else None,
                    stride, k // 2)


def _linear(x, w, name):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _bn(x, w, name):
    return x * w[f"{name}.scale"].view(1, -1, 1, 1) + w[f"{name}.bias"].view(1, -1, 1, 1)


def _bottleneck(x, w, name, stride: int, stride_in_3x3: bool):
    s1, s2 = (1, stride) if stride_in_3x3 else (stride, 1)
    y = F.relu(_bn(_conv(x, w, f"{name}.conv1", s1, False), w, f"{name}.bn1"))
    y = F.relu(_bn(_conv(y, w, f"{name}.conv2", s2, False), w, f"{name}.bn2"))
    y = _bn(_conv(y, w, f"{name}.conv3", 1, False), w, f"{name}.bn3")
    if f"{name}.proj.weight" in w:
        x = _bn(_conv(x, w, f"{name}.proj", stride, False), w, f"{name}.bn_proj")
    return F.relu(y + x)


def trunk(w, canvases, net: dict):
    """(B, H, W, 3) uint8 canvases → (B, H/16, W/16, C) f32 features."""
    means = torch.tensor(PIXEL_MEANS, dtype=torch.float32, device=canvases.device)
    x = (canvases.float() - means).permute(0, 3, 1, 2)
    if net["trunk"] == "vgg16":
        for b, block in enumerate(VGG16_BLOCKS):
            for name in block:
                x = F.relu(_conv(x, w, f"trunk.{name}"))
            if b < 4:
                x = F.max_pool2d(x, 2, 2)
    else:
        depths = RESNET_DEPTHS[int(net["trunk"][len("resnet"):])]
        x = F.relu(_bn(_conv(x, w, "trunk.conv1", 2, False), w, "trunk.bn1"))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for s, n in enumerate(depths[:3]):
            for i in range(n):
                x = _bottleneck(x, w, f"trunk.stage{s + 2}_block{i}",
                                (1 if s == 0 else 2) if i == 0 else 1, net["stride_in_3x3"])
    return x.permute(0, 2, 3, 1)


def rpn(w, feat):
    """Features → (cls logits (B, Hf, Wf, 2A), deltas (B, Hf, Wf, 4A))."""
    x = F.relu(_conv(feat.permute(0, 3, 1, 2), w, "rpn_head.rpn_conv"))
    return (_conv(x, w, "rpn_head.rpn_cls_score").permute(0, 2, 3, 1),
            _conv(x, w, "rpn_head.rpn_bbox_pred").permute(0, 2, 3, 1))


def heads(w, feat, rois, net: dict, resize):
    """Both heads on the RoIs of a batch: (mask logits (B·N, M, M), class
    logits (B·N, C), deltas (B·N, 4C))."""
    m = net["mask_size"]
    rf = roi_warp(feat, rois, net["warp_hw"], 1.0 / net["feat_stride"])
    rf = rf.reshape(-1, *rf.shape[2:])  # (B·N, P, P, C)
    n = rf.shape[0]
    x = F.relu(_linear(rf.reshape(n, -1), w, "mask_head.fc_mask"))
    mask = _linear(x, w, "mask_head.mask_pred").reshape(n, m, m)
    soft = resize @ torch.sigmoid(mask) @ resize.T  # (B·N, P, P)
    pooled = (rf * soft.unsqueeze(-1)).permute(0, 3, 1, 2)
    if net["roi_conv5"]:
        depth = int(net["trunk"][len("resnet"):])
        x = pooled
        for i in range(RESNET_DEPTHS[depth][3]):
            x = _bottleneck(x, w, f"classify_head.stage5_block{i}", 2 if i == 0 else 1,
                            net["stride_in_3x3"])
        x = x.mean(dim=(2, 3))
    else:
        k = net["warp_hw"] // net["pooled_hw"]
        x = F.max_pool2d(pooled, k, k).permute(0, 2, 3, 1).reshape(n, -1)
        x = F.relu(_linear(x, w, "classify_head.fc6"))
        x = F.relu(_linear(x, w, "classify_head.fc7"))
    return mask, _linear(x, w, "classify_head.cls_score"), _linear(x, w, "classify_head.bbox_pred")


# --------------------------------------------------------------------------- #
# Selections
# --------------------------------------------------------------------------- #


def propose(rpn_cls, rpn_bbox, im_info, anchors, trainable, net: dict):
    """RPN outputs → (rois (B, N, 4), valid (B, N), anchor index (B, N)):
    decode, clip, min size, the stable top pre-NMS, NMS, the top post-NMS."""
    b = rpn_cls.shape[0]
    scores = torch.softmax(rpn_cls.reshape(b, -1, 2), -1)[..., 1]
    boxes = clip(decode(anchors, rpn_bbox.reshape(b, -1, 4)), im_info[:, 0:1], im_info[:, 1:2])
    min_size = net["rpn_min_size"] * im_info[:, 2:3]
    valid = ((boxes[..., 2] - boxes[..., 0] + 1.0 >= min_size)
             & (boxes[..., 3] - boxes[..., 1] + 1.0 >= min_size))
    if net["suppress_untrainable_anchors"]:
        valid = valid & trainable
    neg = torch.finfo(torch.float32).min
    top = torch.sort(torch.where(valid, scores, torch.full_like(scores, neg)), dim=-1,
                     descending=True, stable=True)
    pre = net["pre_nms_top_n"]
    ts, ti = top.values[:, :pre], top.indices[:, :pre]
    idx, kv = nms_top(take_rows(boxes, ti), ts, ts > neg, net["rpn_nms_thresh"],
                      net["post_nms_top_n"], presorted=True)
    return take_rows(take_rows(boxes, ti), idx), kv, torch.gather(ti, 1, idx)


def bridge(rois, cls_prob, deltas, im_info, net: dict):
    """The 5-stage bridge: each RoI refined by the deltas of its first-argmax
    foreground class.  Returns (refined rois, the class used)."""
    c = cls_prob.shape[-1]
    fg = cls_prob[..., 1:].argmax(-1) + 1
    d = deltas.reshape(*deltas.shape[:-1], c, 4)
    sel = torch.gather(d, -2, fg[..., None, None].expand(*fg.shape, 1, 4)).squeeze(-2)
    sel = (sel * torch.tensor(net["bbox_stds"], device=sel.device)
           + torch.tensor(net["bbox_means"], device=sel.device))
    return clip(decode(rois, sel), im_info[..., 0:1], im_info[..., 1:2]), fg


def select_detections(rois, roi_valid, cls_prob, post: dict):
    """Per-class NMS → the top ``dets_per_class`` a class → the cross-class top
    ``max_per_image`` → each detection's voting candidates (the top
    ``vote_top_k`` RoIs by its class's score).  rois (B, N, 4), roi_valid
    (B, N), cls_prob (B, N, C) → a dict of (B, K) selections and values."""
    b, n, c = cls_prob.shape
    d = min(post["dets_per_class"], n)
    fg = cls_prob[..., 1:].transpose(1, 2)
    ok = roi_valid.unsqueeze(1) & (fg > post["score_thresh"])
    idx_c, keep_c = nms_top(rois.unsqueeze(1).expand(b, c - 1, n, 4), fg, ok,
                            post["nms_thresh"], d)
    scores_c = torch.where(keep_c, torch.gather(fg, -1, idx_c), torch.zeros((), device=fg.device))
    flat_idx, flat_scores = idx_c.reshape(b, -1), scores_c.reshape(b, -1)
    flat_valid = keep_c.reshape(b, -1)
    flat_cls = torch.arange(1, c, device=rois.device).repeat_interleave(d)
    k = min(post["max_per_image"], (c - 1) * d)
    key = torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0))
    top = torch.sort(key, dim=-1, descending=True, stable=True)
    scores, top_idx = top.values[:, :k], top.indices[:, :k]
    roi_idx = torch.gather(flat_idx, 1, top_idx)
    classes = flat_cls[top_idx]
    kv = min(post["vote_top_k"], n)
    cand = torch.gather(cls_prob.transpose(1, 2), 1, classes.unsqueeze(-1).expand(b, k, n))
    cand = torch.where(roi_valid.unsqueeze(1), cand, torch.zeros((), device=cand.device))
    cs = torch.sort(cand, dim=-1, descending=True, stable=True)
    return {"roi_idx": roi_idx, "classes": classes, "scores": scores,
            "boxes": take_rows(rois, roi_idx), "valid": scores > 0.0,
            "cand_idx": cs.indices[..., :kv], "cand_scores": cs.values[..., :kv]}


def detection_masks(sel: dict, rois, mask_logits, cand_scores, canvas_hw, post: dict):
    """Voted soft masks and bool canvases of selected detections: candidates
    ``sel["cand_idx"]`` weighed by ``cand_scores`` (B, K, V), their soft masks
    from ``mask_logits`` (B, N, M, M) at ``rois``."""
    b, k, v = sel["cand_idx"].shape
    m = mask_logits.shape[-1]
    ci = sel["cand_idx"]
    cand_boxes = take_rows(rois, ci).reshape(b * k, v, 4)
    cand_masks = take_rows(torch.sigmoid(mask_logits), ci).reshape(b * k, v, m, m)
    det = vote_masks(sel["boxes"].reshape(b * k, 4), cand_boxes, cand_scores.reshape(b * k, v),
                     cand_masks, post["mask_merge_iou"])
    canvas = paste(det, sel["boxes"].reshape(b * k, 4), canvas_hw, post["binarize_thresh"])
    return det.reshape(b, k, m, m), canvas.reshape(b, k, *canvas_hw)
