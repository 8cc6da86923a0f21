"""Inference: BGR images → per-instance (box, class, score, mask) at the
original resolution — port of ``mnc_tpu/pipeline/inference.py``.

The canvas-space half: per-class NMS, mask voting (``lib/nms/mv.pyx``), the
cross-class top-K and the full-canvas paste-back, batched over images so
each kernel launches once per batch: per-class NMS runs B × (C−1) problems
in one launch of kernel B, and the paste runs every detection of the batch
in one launch of kernel C.

The host half (``MNCPipeline.detect`` / ``detect_many``): the canvas each
image runs on (``TEST.AUTO_PORTRAIT``, ``TEST.CANVAS_BUCKETS``), the resize
into it (``utils.blob.prep_im_for_blob``, cv2's arithmetic, on the model's
device: only the uint8 original is uploaded), and the way back to the
original resolution: boxes divided by the scale, the canvas masks cropped
and resized (``_resize_mask_to``, on the device) or, with
``TEST.HOST_PASTE``, the soft masks unmolded per detection on the host.
``TEST.PACKED_TRANSFER`` bit-packs the masks on the device before they
cross (8× fewer bytes; the same outputs).  Where the JAX package transfers
the packed canvases and resizes on the host with ``cv2``, the port resizes
on the device and transfers the packed original-resolution masks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.ops.bbox import take_rows
from mnc_tpu_torch.ops.mask_voting import box_voting_per_det, mask_voting_per_det
from mnc_tpu_torch.ops.masks import paste_masks
from mnc_tpu_torch.ops.nms import nms_indices
from mnc_tpu_torch.utils import spans
from mnc_tpu_torch.utils.blob import prep_im_for_blob, resize_linear

if TYPE_CHECKING:  # the host half runs without the model code (pipeline/export.py)
    from mnc_tpu_torch.models.mnc import MNC, MNCArch


@dataclasses.dataclass(frozen=True)
class PostCfg:
    """Post-processing configuration (reference TEST.* semantics).

    ``vote_impl`` (``TEST.VOTE_IMPL``) chooses the voting resample, as in the
    JAX package.  Its ``paste_impl`` and ``paste_dtype`` choose between XLA
    formulations of the paste; the port pastes in f32 (kernel C on the
    GPU), so it has no such fields."""

    nms_thresh: float = 0.3  # TEST.NMS per-class box NMS
    dets_per_class: int = 16  # padded per-class keep
    max_per_image: int = 100  # TEST.MAX_PER_IMAGE cross-class cap
    use_mask_merge: bool = True  # TEST.USE_MASK_MERGE
    mask_merge_iou: float = 0.5  # TEST.MASK_MERGE_IOU_THRESH
    # voting candidate pool per class: the top vote_top_k by score
    vote_top_k: int = 64
    # TEST.VOTE_BOXES: also average the detection box over the same weighted
    # neighbor set; the merged mask is then voted into the averaged box
    vote_boxes: bool = False
    # TEST.VOTE_BOTH_PASSES (5-stage): pool the first-pass detections too
    vote_both_passes: bool = False
    score_thresh: float = 0.0  # candidates below are dropped
    paste: bool = True  # paste the masks into full canvases
    binarize_thresh: float = 0.4  # cfg.BINARIZE_THRESH
    # TEST.VOTE_IMPL: the voting resample, "einsum" (per-pair hat products)
    # or "gather" (separable 2-tap gather; the same math to f32 rounding)
    vote_impl: str = "einsum"

    @classmethod
    def from_cfg(cls, **over) -> "PostCfg":
        # the reference tester NMS'd with MASK_MERGE_NMS_THRESH when voting was
        # on and TEST.NMS otherwise (both 0.3 by default)
        kw = dict(
            nms_thresh=(cfg.TEST.MASK_MERGE_NMS_THRESH
                        if cfg.TEST.USE_MASK_MERGE else cfg.TEST.NMS),
            max_per_image=cfg.TEST.MAX_PER_IMAGE,
            use_mask_merge=bool(cfg.TEST.USE_MASK_MERGE),
            mask_merge_iou=cfg.TEST.MASK_MERGE_IOU_THRESH,
            vote_boxes=bool(cfg.TEST.VOTE_BOXES),
            vote_both_passes=bool(cfg.TEST.VOTE_BOTH_PASSES),
            binarize_thresh=cfg.BINARIZE_THRESH,
            vote_impl=str(cfg.TEST.VOTE_IMPL),
        )
        kw.update(over)
        return cls(**kw)


def postprocess_detections(rois: torch.Tensor, roi_valid: torch.Tensor,
                           cls_prob: torch.Tensor, mask_logits: torch.Tensor,
                           post: PostCfg, canvas_hw: tuple[int, int] | None) -> dict:
    """Fixed-shape detection post-processing of a batch.

    Inputs (B, N, 4), (B, N), (B, N, C), (B, N, M, M).  Per foreground class:
    NMS over (rois, class score) → top dets_per_class; then a cross-class top
    max_per_image cut; mask voting merges candidate soft masks into each
    survivor; the masks are pasted into bool canvases.  Returns padded
    (B, K, ...) arrays + ``valid``.  Every top-K is a stable sort, so ties
    keep the lower index first, as ``lax.top_k``.
    """
    b, n, c = cls_prob.shape
    soft_masks = torch.sigmoid(mask_logits)
    d = min(post.dets_per_class, n)

    fg_scores = cls_prob[..., 1:].transpose(1, 2)  # (B, C-1, N)
    ok = roi_valid.unsqueeze(1) & (fg_scores > post.score_thresh)
    idx_c, keep_c = nms_indices(rois.unsqueeze(1).expand(b, c - 1, n, 4), fg_scores,
                                ok, post.nms_thresh, d)  # (B, C-1, d)
    scores_c = torch.where(keep_c, torch.gather(fg_scores, -1, idx_c),
                           torch.zeros((), device=rois.device))
    flat_idx = idx_c.reshape(b, -1)
    flat_scores = scores_c.reshape(b, -1)
    flat_valid = keep_c.reshape(b, -1)
    flat_cls = torch.arange(1, c, device=rois.device).repeat_interleave(d)

    k = min(post.max_per_image, (c - 1) * d)
    key = torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0))
    top = torch.sort(key, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :k], top.indices[:, :k]
    roi_idx = torch.gather(flat_idx, 1, top_idx)  # original roi of each detection
    det_boxes = take_rows(rois, roi_idx)
    det_classes = flat_cls[top_idx]

    if post.use_mask_merge:
        # vote only the K survivors, each against the top vote_top_k
        # candidates of ITS class (score-weighted IoU neighbors)
        kv = min(post.vote_top_k, n)
        cand = torch.gather(cls_prob.transpose(1, 2), 1,
                            det_classes.unsqueeze(-1).expand(b, k, n))  # (B, K, N)
        cand = torch.where(roi_valid.unsqueeze(1), cand, torch.zeros((), device=cand.device))
        cs_sort = torch.sort(cand, dim=-1, descending=True, stable=True)
        cs, ci = cs_sort.values[..., :kv], cs_sort.indices[..., :kv]  # (B, K, kv)
        cand_boxes = take_rows(rois, ci).reshape(b * k, kv, 4)
        cs = cs.reshape(b * k, kv)
        flat_boxes = det_boxes.reshape(b * k, 4)
        if post.vote_boxes:
            flat_boxes = box_voting_per_det(flat_boxes, cand_boxes, cs, post.mask_merge_iou)
            det_boxes = flat_boxes.reshape(b, k, 4)
        cand_masks = take_rows(soft_masks, ci).reshape(b * k, kv, *soft_masks.shape[-2:])
        det_masks = mask_voting_per_det(flat_boxes, cand_boxes, cs, cand_masks,
                                        post.mask_merge_iou, impl=post.vote_impl)
        det_masks = det_masks.reshape(b, k, *soft_masks.shape[-2:])
    else:
        det_masks = take_rows(soft_masks, roi_idx)

    out = {
        "boxes": det_boxes,
        "scores": top_scores,
        "classes": det_classes,
        "masks": det_masks,
        "valid": top_scores > 0.0,
    }
    if post.paste and canvas_hw is not None:
        out["canvas_masks"] = paste_masks(det_masks, det_boxes, canvas_hw,
                                          post.binarize_thresh)
    return out


def vote_candidates(net_out: dict, post: PostCfg, n_stages: int, axis: int = 0):
    """(rois, valid, prob, masks) for postprocess — optionally pooling the
    5-stage first-pass detections too (PostCfg.vote_both_passes)."""
    keys = ("rois", "roi_valid", "cls_prob", "mask_logits")
    r, v, c, m = (net_out[k] for k in keys)
    if post.vote_both_passes and n_stages == 5:
        r = torch.cat([r, net_out["stage3_rois"]], axis)
        v = torch.cat([v, net_out["roi_valid"]], axis)
        c = torch.cat([c, net_out["stage3_cls_prob"]], axis)
        m = torch.cat([m, net_out["stage3_mask_logits"]], axis)
    return r, v, c, m


class MNCPipeline:
    """The serving front-end: the network and the post-processing on the
    model's device, and the host API around them.

        model = MNC(MNCArch.from_cfg())          # cuda; device="cpu" to ask
        model.load_state_dict(state_dict_from_jax(params))
        pipe = MNCPipeline(model)
        dets = pipe.detect(bgr_image)            # original-resolution numpy dict
        dets = pipe.detect_many(bgr_images, batch_size=8)

    ``detect_canvas[_batch]`` take canvases that are already sized: (B, H,
    W, 3) uint8 (mean-subtracted on the device) or mean-subtracted float, at
    the model's canvas size, with im_infos (B, 3) = (scaled h, scaled w,
    scale); numpy inputs are moved to the device.  Other canvases (portrait,
    buckets) run on :meth:`MNC.for_canvas` views of the same parameters.
    """

    def __init__(self, model: MNC, post: PostCfg | None = None):
        self.model = model
        self.arch: MNCArch = model.arch
        self.post = post or PostCfg.from_cfg()
        self._variants = {tuple(model.arch.canvas): model}

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _variant(self, canvas_hw: tuple[int, int]) -> MNC:
        """The model for a canvas: this one, or a view of its parameters."""
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._variants:
            self._variants[canvas_hw] = self.model.for_canvas(canvas_hw)
        return self._variants[canvas_hw]

    @torch.inference_mode()
    def _run_batch(self, model: MNC, canvases, im_infos, paste: bool = True,
                   packed: bool = False) -> dict:
        """Cascade + post-processing of a batch on ``model``'s canvas; the
        canvas masks bit-packed along W with ``packed``, left out without
        ``paste``."""
        with spans.setup_span("mnc.first_request"), spans.span("mnc.request", request=True):
            canvases = torch.as_tensor(canvases, device=self.device)
            im_infos = torch.as_tensor(im_infos, dtype=torch.float32, device=self.device)
            net_out = model.apply_batch(canvases, im_infos)
            post = self.post if paste else dataclasses.replace(self.post, paste=False)
            r, v, c, m = vote_candidates(net_out, post, model.arch.n_stages, axis=1)
            out = postprocess_detections(r, v, c, m, post, model.arch.canvas)
            if packed and "canvas_masks" in out:
                with spans.span("mnc.pack", self.device):
                    out["canvas_masks"] = pack_bits(out["canvas_masks"])
        return out

    def detect_canvas_batch(self, canvases, im_infos) -> dict:
        """Batched throughput path: (B, H, W, 3) + (B, 3) → batched dets."""
        return self._run_batch(self.model, canvases, im_infos)

    def detect_canvas(self, canvas, im_info) -> dict:
        """One (H, W, 3) canvas + (3,) im_info → dets without the batch dim."""
        out = self.detect_canvas_batch(torch.as_tensor(canvas)[None],
                                       torch.as_tensor(im_info)[None])
        return {k: v[0] for k, v in out.items()}

    def detect_canvas_batch_packed(self, canvases, im_infos) -> dict:
        """:meth:`detect_canvas_batch` with the (B, K, H, W) canvas masks
        bit-packed on the device to (B, K, H, W/8) uint8 (8× less to
        transfer); :func:`unpack_canvas_masks` undoes it on the host."""
        return self._run_batch(self.model, canvases, im_infos, packed=True)

    def detect_canvas_packed(self, canvas, im_info) -> dict:
        """:meth:`detect_canvas` with bit-packed canvas masks."""
        out = self.detect_canvas_batch_packed(torch.as_tensor(canvas)[None],
                                              torch.as_tensor(im_info)[None])
        return {k: v[0] for k, v in out.items()}

    def _pick_canvas(self, h0: int, w0: int, auto_orient: bool) -> tuple[int, int]:
        """Smallest canvas that admits the full reference scale for this
        image: the primary canvas, its transpose (``auto_orient``), and any
        ``TEST.CANVAS_BUCKETS`` entry (orientation-matched)."""
        canvas = tuple(self.arch.canvas)
        if auto_orient and (h0 > w0) != (canvas[0] > canvas[1]):
            canvas = (canvas[1], canvas[0])
        buckets = [tuple(b) for b in (cfg.TEST.CANVAS_BUCKETS or ())]
        if not buckets:
            return canvas
        stride = self.arch.feat_stride
        cands = [canvas]
        for bh, bw in buckets:
            if bh % stride or bw % stride:
                raise ValueError(f"CANVAS_BUCKETS entries must be multiples of {stride}")
            if auto_orient and (h0 > w0) != (bh > bw):
                bh, bw = bw, bh
            cands.append((bh, bw))
        # the raw reference scale (shorter side → SCALES[0], longer capped)
        short, long = min(h0, w0), max(h0, w0)
        scale = float(cfg.TEST.SCALES[0]) / short
        if round(scale * long) > cfg.TEST.MAX_SIZE:
            scale = float(cfg.TEST.MAX_SIZE) / long
        hs, ws = h0 * scale, w0 * scale
        fitting = [b for b in cands if b[0] >= hs and b[1] >= ws]
        return min(fitting, key=lambda b: b[0] * b[1]) if fitting else canvas

    def _modes(self, auto_orient, packed, host_paste) -> tuple[bool, bool, bool]:
        """The host API's switches, from cfg.TEST where not given.
        ``host_paste`` wins over ``packed``: nothing is pasted to pack."""
        if auto_orient is None:
            auto_orient = bool(cfg.TEST.AUTO_PORTRAIT)
        if host_paste is None:
            host_paste = bool(cfg.TEST.HOST_PASTE)
        if packed is None:
            packed = bool(cfg.TEST.PACKED_TRANSFER) and self.post.paste
        return bool(auto_orient), bool(packed) and not host_paste, bool(host_paste)

    def detect(self, bgr_image, auto_orient: bool | None = None,
               packed: bool | None = None, host_paste: bool | None = None) -> dict:
        """Full host API: a BGR uint8 image (H0, W0, 3) → numpy dict at the
        original resolution: boxes (K, 4), scores (K,), classes (K,), valid
        (K,), soft masks (K, M, M) in box frames, and full_masks (K, H0, W0)
        uint8 when pasting is on.

        ``auto_orient`` (default ``TEST.AUTO_PORTRAIT``): portrait images run
        on the transposed canvas, at the full reference scale.  ``packed``
        (default ``TEST.PACKED_TRANSFER``): bit-pack the masks on the device,
        unpack on the host — the same outputs, 8× fewer bytes.
        ``host_paste`` (default ``TEST.HOST_PASTE``): no canvas paste; the
        soft masks are unmolded into their boxes on the host per valid
        detection (the reference's own unmold); boxes, scores and soft
        masks are those of the pasting route, full_masks differ by the
        resampling route."""
        return self.detect_many([bgr_image], batch_size=1, auto_orient=auto_orient,
                                packed=packed, host_paste=host_paste)[0]

    def detect_many(self, bgr_images, batch_size: int = 8, auto_orient: bool | None = None,
                    packed: bool | None = None, host_paste: bool | None = None,
                    max_in_flight: int = 4, timings: dict | None = None) -> list[dict]:
        """Batched mixed-size host API: BGR images → one :meth:`detect` dict
        each.

        Images are grouped by their canvas and run through ``apply_batch``
        in chunks of ``batch_size``; a short last chunk is padded by
        repeating its last image.  Chunks are dispatched without waiting;
        at most ``max_in_flight`` chunks' outputs stay on the device before
        the oldest is fetched, so a long stream holds O(max_in_flight)
        device memory.  ``timings`` (a dict) accumulates seconds per phase —
        ``prep`` (canvas picking, upload and resize), ``device`` (cascade,
        post-processing, mask resize and packing), ``transfer`` (device →
        host) and ``finalize`` (unpacking, host unmold) — with a device
        synchronize closing each, which serializes what would overlap.
        """
        auto_orient, packed, host_paste = self._modes(auto_orient, packed, host_paste)
        lap = _Laps(timings, self.device)
        preps, groups = [], {}
        u8 = bool(cfg.TEST.U8_TRANSFER)
        for i, im in enumerate(bgr_images):
            h0, w0 = im.shape[:2]
            chw = self._pick_canvas(h0, w0, auto_orient)
            canvas, info = prep_im_for_blob(im, canvas_hw=chw, u8=u8, device=self.device)
            preps.append((canvas, info, (h0, w0)))
            groups.setdefault(chw, []).append(i)
        lap("prep")
        results: list = [None] * len(preps)

        def fetch(chunk, dev_out):
            for k, j in enumerate(chunk):
                out = self._finalize_host({key: v[k] for key, v in dev_out.items()},
                                          preps[j][2], preps[j][1], packed, lap)
                if host_paste:
                    out["full_masks"] = unmold_masks_host(
                        out["masks"], out["boxes"], out["valid"], preps[j][2],
                        self.post.binarize_thresh)
                    lap("finalize")
                results[j] = out

        pending: list = []
        for chw, idxs in groups.items():
            model = self._variant(chw)
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                sel = chunk + [chunk[-1]] * (batch_size - len(chunk))
                images = torch.stack([preps[j][0] for j in sel])
                infos = np.stack([preps[j][1] for j in sel])
                pending.append((chunk, self._run_batch(model, images, infos,
                                                       paste=not host_paste)))
                lap("device")
                if len(pending) >= max(1, max_in_flight):
                    fetch(*pending.pop(0))
        for item in pending:
            fetch(*item)
        return results

    @staticmethod
    @torch.inference_mode()
    def _finalize_host(dets: dict, orig_hw: tuple[int, int], im_info, packed: bool,
                       lap: "_Laps | None" = None) -> dict:
        """One image's canvas-space outputs (on the device) → the host dict
        at the original resolution.  The canvas masks are cropped to the
        scaled image and resized to the original size where they lie, then
        (``packed``) bit-packed; only that result crosses to the host."""
        lap = lap or _Laps(None, None)
        scale = float(im_info[2])
        full = None
        if "canvas_masks" in dets:
            sh, sw = int(im_info[0]), int(im_info[1])
            full = _resize_mask_to(dets["canvas_masks"][:, :sh, :sw], orig_hw)
            if packed:
                full = pack_bits(full)
        lap("device")
        host = {k: v.cpu().numpy() for k, v in dets.items() if k != "canvas_masks"}
        if full is not None:
            full = full.cpu().numpy()
        lap("transfer")
        out = {"boxes": host["boxes"] / scale, "scores": host["scores"],
               "classes": host["classes"], "masks": host["masks"], "valid": host["valid"]}
        if full is not None:
            out["full_masks"] = (np.unpackbits(full, axis=-1, count=orig_hw[1]) if packed
                                 else full)
        lap("finalize")
        return out

    def prewarm(self, batch_size: int | None = None, auto_orient: bool | None = None,
                packed: bool | None = None, host_paste: bool | None = None
                ) -> list[tuple[int, int]]:
        """Run one dummy image through every canvas :meth:`detect` /
        :meth:`detect_many` can pick — the primary canvas, each
        ``TEST.CANVAS_BUCKETS`` entry, and their transposes with
        ``auto_orient`` — and, with ``batch_size``, one batch of that size
        each, so the kernels are built and the allocator holds its pools
        before the first request.  Returns the canvases, in order."""
        auto_orient, packed, host_paste = self._modes(auto_orient, packed, host_paste)
        cands = [tuple(self.arch.canvas)]
        cands += [tuple(b) for b in (cfg.TEST.CANVAS_BUCKETS or ())]
        if auto_orient:
            cands += [(w, h) for h, w in cands]
        canvases = list(dict.fromkeys(cands))
        u8 = bool(cfg.TEST.U8_TRANSFER)
        for chw in canvases:
            canvas, info = prep_im_for_blob(np.zeros((*chw, 3), np.uint8), canvas_hw=chw,
                                            u8=u8, device=self.device)
            for b in sorted({1, batch_size or 1}):
                out = self._run_batch(self._variant(chw), canvas.expand(b, *canvas.shape),
                                      np.stack([info] * b), paste=not host_paste,
                                      packed=packed)
                out["valid"].cpu()  # wait for it
        return canvases


class _Laps:
    """Seconds per phase, each closed by a device synchronize; a no-op
    without a dict to fill."""

    def __init__(self, timings: dict | None, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[phase] = self.timings.get(phase, 0.0) + now - self.t
        self.t = now


def pack_bits(masks: torch.Tensor) -> torch.Tensor:
    """``np.packbits(masks, axis=-1)`` on the masks' device: 8 pixels per
    byte, the first in the high bit, W padded with zeros to a multiple of 8."""
    m = torch.nn.functional.pad(masks.to(torch.uint8), (0, (-masks.shape[-1]) % 8))
    m = m.reshape(*m.shape[:-1], -1, 8).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=m.device)
    return (m << shifts).sum(-1).to(torch.uint8)


def unpack_canvas_masks(dets: dict, canvas_w: int) -> dict:
    """Host-side inverse of the packed detect paths: canvas_masks (…, W/8)
    uint8 → (…, W) bool (numpy)."""
    if "canvas_masks" in dets and dets["canvas_masks"].shape[-1] != canvas_w:
        dets = dict(dets, canvas_masks=np.unpackbits(
            np.asarray(dets["canvas_masks"]), axis=-1, count=canvas_w).astype(bool))
    return dets


def _resize_mask_to(masks: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Binary masks (…, h, w) → uint8 (…, H, W): cv2's bilinear resize of
    the 0/1 values, thresholded at > 0.5 (ties at 0.5 stay 0; cv2's exact
    arithmetic decides which pixels tie)."""
    lead = masks.shape[:-2]
    x = masks.reshape(-1, *masks.shape[-2:], 1).float()
    out = resize_linear(x, out_hw=tuple(hw)) > 0.5
    return out.reshape(*lead, *hw).to(torch.uint8)


def _resize_soft(m, hw: tuple[int, int]) -> np.ndarray:
    """One soft (M, M) mask → (h, w) float32 by cv2's bilinear resize."""
    return resize_linear(torch.as_tensor(np.asarray(m, np.float32)), out_hw=hw).numpy()


def unmold_masks_host(masks: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
                      hw: tuple[int, int], binarize_thresh: float = 0.4) -> np.ndarray:
    """Host-side unmold (the reference tester's): per valid detection,
    resize its (M, M) soft mask into its rounded box and threshold, in a
    full (H, W) canvas.  boxes are at the target resolution; invalid rows
    stay zero.  Returns (K, H, W) uint8."""
    h, w = hw
    out = np.zeros((len(masks), h, w), np.uint8)
    for k in range(len(masks)):
        if not valid[k]:
            continue
        x1, y1, x2, y2 = boxes[k]
        xi1, yi1 = max(int(np.round(x1)), 0), max(int(np.round(y1)), 0)
        xi2 = min(int(np.round(x2)) + 1, w)
        yi2 = min(int(np.round(y2)) + 1, h)
        if xi2 <= xi1 or yi2 <= yi1:
            continue
        m = _resize_soft(masks[k], (yi2 - yi1, xi2 - xi1))
        out[k, yi1:yi2, xi1:xi2] = (m > binarize_thresh).astype(np.uint8)
    return out
