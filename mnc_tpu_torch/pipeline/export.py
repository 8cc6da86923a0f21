"""Serialized deployment artifacts via ``torch.export`` — port of
``mnc_tpu/pipeline/export.py``.

The artifact is the whole canvas-space inference program (trunk → RPN →
proposal NMS → cascade → per-class NMS, voting and paste) as one
``torch.export`` program with the weights inside, the counterpart of the
JAX package's StableHLO export (and of the reference's prototxt +
caffemodel pair).  The kernels are the custom ops ``mnc::roi_warp``,
``mnc::nms_keep``, ``mnc::paste_binarize`` and ``mnc::block1``, one node
each; a consumer imports the four op modules that register them (this module
does) and no model code.

    blob = export_inference(model, post)            # bytes (a .pt2 zip)
    fn = deserialize_inference(blob)                # callable
    dets = fn(canvas, im_info)                      # same dict as detect_canvas

The artifact runs on the device it was exported on: exported on the card it
launches the port's kernels (built from the checkout at their first call),
exported on the CPU it runs their plain versions.  The JAX artifact is
lowered for the CPU and the TPU in one file; here each device needs its own
export.  Host-side pre- and post-processing (the resize to the canvas, the
way back to the original resolution) stays outside the artifact, as it stays
outside the device program in ``MNCPipeline``.
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile

import torch

# importing these registers the custom ops that the program calls
import mnc_tpu_torch.ops.block1  # noqa: F401
import mnc_tpu_torch.ops.masks  # noqa: F401
import mnc_tpu_torch.ops.nms  # noqa: F401
import mnc_tpu_torch.ops.roi_warp  # noqa: F401
from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.pipeline.inference import (MNCPipeline, PostCfg, postprocess_detections,
                                              unmold_masks_host, vote_candidates)
from mnc_tpu_torch.utils.blob import prep_im_for_blob

# the host-side knobs the program was exported under ride along as JSON, so
# that a consumer cannot silently diverge from the live pipeline
_META = "mnc_meta.json"


class _CanvasProgram(torch.nn.Module):
    """``apply_batch`` → ``vote_candidates`` → ``postprocess_detections``;
    with ``single`` on one (H, W, 3) canvas and its (3,) im_info, without the
    batch dim, as ``MNCPipeline.detect_canvas``."""

    def __init__(self, model, post: PostCfg, single: bool):
        super().__init__()
        self.model, self.post, self.single = model, post, single

    def forward(self, canvases: torch.Tensor, im_infos: torch.Tensor) -> dict:
        if self.single:
            canvases, im_infos = canvases[None], im_infos[None]
        arch = self.model.arch
        net_out = self.model.apply_batch(canvases, im_infos)
        r, v, c, m = vote_candidates(net_out, self.post, arch.n_stages, axis=1)
        out = postprocess_detections(r, v, c, m, self.post, arch.canvas)
        return {k: t[0] for k, t in out.items()} if self.single else out


def export_inference(model, post: PostCfg | None = None, batch: int | None = None) -> bytes:
    """Serialize the inference program of ``model`` (weights inside) to bytes.

    ``batch=None`` exports the single-image program ``(H, W, 3), (3,) f32 →
    detections dict``; ``batch=B`` the batched one ``(B, H, W, 3), (B, 3) →
    batched dict`` (``MNCPipeline.detect_canvas_batch``).  Canvases are
    uint8 under ``TEST.U8_TRANSFER`` (the default), else mean-subtracted
    f32, as ``prep_im_for_blob`` makes them.  The trace runs under
    ``torch.no_grad()``: a ``no_grad`` block nested in the traced code (the
    frozen trunk blocks) would otherwise leave a node that the loader
    rejects.
    """
    post = post or PostCfg.from_cfg()
    arch, dev = model.arch, model.device
    u8 = bool(cfg.TEST.U8_TRANSFER)
    lead = () if batch is None else (int(batch),)
    canvases = torch.zeros((*lead, *arch.canvas, 3), device=dev,
                           dtype=torch.uint8 if u8 else torch.float32)
    im_infos = torch.tensor([float(arch.canvas[0]), float(arch.canvas[1]), 1.0],
                            device=dev).expand(*lead, 3).contiguous()
    # fill the per-(arch, device) constant cache eagerly: filled inside the
    # trace it would keep fake tensors, which later eager calls would get
    from mnc_tpu_torch.models.mnc import _arch_constants

    _arch_constants(arch, dev)
    with torch.no_grad():
        program = torch.export.export(_CanvasProgram(model, post, batch is None),
                                      (canvases, im_infos), strict=False)
    meta = {"binarize_thresh": post.binarize_thresh, "paste": post.paste,
            "canvas": list(arch.canvas), "batch": batch, "u8": u8, "device": dev.type}
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # the soft-mask resize matrix is a transposed view of its storage; the
        # writer warns, then saves the storage it spans, on any device
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, buf, extra_files={_META: json.dumps(meta, sort_keys=True)})
    return buf.getvalue()


def _read(path_or_blob) -> bytes:
    if isinstance(path_or_blob, (bytes, bytearray)):
        return bytes(path_or_blob)
    with open(path_or_blob, "rb") as f:
        return f.read()


def exported_meta(blob: bytes) -> dict:
    """The host knobs an artifact was exported under, read from its archive
    without loading the program."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = [n for n in z.namelist() if n.endswith("/" + _META)]
        if len(names) != 1:
            raise ValueError(f"not an artifact of export_inference: no {_META} inside")
        return json.loads(z.read(names[0]))


def deserialize_inference(blob: bytes):
    """bytes → callable with the exported signature."""
    module = torch.export.load(io.BytesIO(bytes(blob))).module()

    def call(canvases, im_infos):
        with torch.inference_mode():
            return module(canvases, im_infos)

    return call


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported(path: str):
    return deserialize_inference(_read(path))


class ExportedPipeline:
    """``detect()`` over a single-image artifact, without the model code.

    The consuming process needs only PyTorch and the host halves (the resize
    into the canvas, ``prep_im_for_blob``; the way back to the original
    resolution, ``MNCPipeline._finalize_host``); the network, NMS, voting
    and paste-back are inside the artifact.

        pipe = ExportedPipeline("mnc.pt2")
        dets = pipe.detect(bgr_image)   # same dict contract as MNCPipeline.detect

    The canvas is the artifact's: portrait images are not moved to the
    transposed canvas and ``TEST.CANVAS_BUCKETS`` is not read.  The device
    is the one the artifact was exported on; a ``device`` of another type
    is refused before the program is loaded.
    """

    def __init__(self, path_or_blob, binarize_thresh: float | None = None,
                 device: torch.device | str | None = None):
        blob = _read(path_or_blob)
        self.meta = exported_meta(blob)
        if self.meta.get("batch") is not None:
            raise ValueError(f"ExportedPipeline drives the single-image artifact; this one "
                             f"takes batches of {self.meta['batch']} (call it directly)")
        self.device = torch.device(self.meta["device"])
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"the artifact was exported on {self.device.type} and runs "
                             f"there, not on {torch.device(device).type}")
        self.canvas: tuple[int, int] = tuple(self.meta["canvas"])
        self._fn = deserialize_inference(blob)
        # host unmold threshold: explicit argument > artifact meta > PostCfg default
        if binarize_thresh is None:
            binarize_thresh = self.meta.get("binarize_thresh", PostCfg.binarize_thresh)
        self.binarize_thresh = float(binarize_thresh)

    def detect(self, bgr_image) -> dict:
        """BGR uint8 image → original-resolution detections (numpy dict)."""
        canvas, im_info = prep_im_for_blob(bgr_image, canvas_hw=self.canvas,
                                           u8=self.meta["u8"], device=self.device)
        dets = self._fn(canvas, torch.as_tensor(im_info, device=self.device))
        packed = bool(cfg.TEST.PACKED_TRANSFER)
        out = MNCPipeline._finalize_host(dets, bgr_image.shape[:2], im_info, packed)
        if "full_masks" not in out:  # artifact exported with paste=False
            out["full_masks"] = unmold_masks_host(out["masks"], out["boxes"], out["valid"],
                                                  bgr_image.shape[:2], self.binarize_thresh)
        return out
