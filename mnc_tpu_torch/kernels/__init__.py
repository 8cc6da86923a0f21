"""ctypes wrappers of the port's CUDA kernels, with launch counters.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
returns a CUDA error, and then adds one to its ``launches`` counter — a
plain integer attribute, so a run can show which kernels the main path
went through.  The ops modules register each kernel as a ``torch.library``
custom op (``mnc::roi_warp``, ``mnc::nms_keep``, ``mnc::paste_binarize``,
``mnc::block1``, ``mnc::gemm_s8``) whose CUDA implementation calls the wrapper here and whose
CPU implementation is the plain PyTorch version; the gradients (A′, and D's
backward through its plain version) are called from ``autograd.Function``s.
Nothing here falls back.

    roi_warp_cuda        — kernel A, csrc/roi_warp.cu (replaces roi_warp_pallas)
    roi_warp_bwd_cuda    — kernel A', csrc/roi_warp_bwd.cu (replaces its VJP)
    nms_keep_cuda        — kernel B, csrc/nms.cu      (replaces nms_pallas)
    paste_binarize_cuda  — kernel C, csrc/paste.cu    (replaces paste_binarize_pallas)
    block1_cuda          — kernel D, csrc/block1.cu   (replaces fused_block1)
    gemm_s8_cuda         — kernel E, csrc/gemm_s8.cu  (the int8 conv / dense of
                           ops/quant.py; no Pallas counterpart)
"""

from __future__ import annotations

import torch

from mnc_tpu_torch.kernels._build import build, kernel_function  # noqa: F401


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, device=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = kernel_function(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def roi_warp_cuda(features: torch.Tensor, rois: torch.Tensor, out_hw,
                  spatial_scale: float) -> torch.Tensor:
    """features (B, H, W, C) f32/bf16, rois (B, N, 4) f32 → (B, N, PH, PW, C)."""
    _check(features, "features", (torch.float32, torch.bfloat16), 4)
    _check(rois, "rois", (torch.float32,), 3, features.device)
    b, h, w, c = features.shape
    if rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois shape {tuple(rois.shape)} does not match "
                         f"features {tuple(features.shape)}")
    vec = 4 if features.dtype == torch.float32 else 8
    if c % vec:
        raise ValueError(f"channels ({c}) must be a multiple of {vec}")
    ph, pw = out_hw
    n = rois.shape[1]
    out = torch.empty((b, n, ph, pw, c), dtype=features.dtype, device=features.device)
    _launch("roi_warp", features.device, features.data_ptr(), rois.data_ptr(),
            out.data_ptr(), b, h, w, c, n, ph, pw, float(spatial_scale),
            0 if features.dtype == torch.float32 else 1, _stream(features))
    roi_warp_cuda.launches += 1
    return out


def roi_warp_bwd_cuda(grad_out: torch.Tensor, features: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float):
    """Gradients of :func:`roi_warp_cuda`: grad_out (B, N, PH, PW, C) and
    features (B, H, W, C), both f32 or both bf16, rois (B, N, 4) f32 →
    (d features (B, H, W, C) in the feature dtype, d rois (B, N, 4) f32).

    d features is summed per RoI in registers, added to an f32 map with one
    atomic per footprint cell and cast once, so its last bits vary from run
    to run; d rois is reduced in a fixed order inside the kernel and is
    deterministic."""
    _check(features, "features", (torch.float32, torch.bfloat16), 4)
    _check(grad_out, "grad_out", (features.dtype,), 5, features.device)
    _check(rois, "rois", (torch.float32,), 3, features.device)
    b, h, w, c = features.shape
    n = rois.shape[1]
    ph, pw = grad_out.shape[2:4]
    if tuple(rois.shape) != (b, n, 4) or tuple(grad_out.shape) != (b, n, ph, pw, c):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} / rois {tuple(rois.shape)} do "
                         f"not match features {tuple(features.shape)}")
    vec = 4 if features.dtype == torch.float32 else 8
    if c % vec:
        raise ValueError(f"channels ({c}) must be a multiple of {vec}")
    if pw > 32 or ph + pw > 512:
        raise ValueError(f"output size {(ph, pw)}: at most 32 columns and 512 rows + columns")
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=features.device)
    drois = torch.empty((b, n, 4), dtype=torch.float32, device=features.device)
    _launch("roi_warp_bwd", features.device, grad_out.data_ptr(), features.data_ptr(),
            rois.data_ptr(), dfeat.data_ptr(), drois.data_ptr(), b, h, w, c, n, ph, pw,
            float(spatial_scale), 0 if features.dtype == torch.float32 else 1,
            _stream(features))
    roi_warp_bwd_cuda.launches += 1
    return dfeat.to(features.dtype), drois


def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                  top_n: int = 0) -> torch.Tensor:
    """Greedy NMS keep masks: boxes (P, K, 4) f32 score-sorted, valid (P, K)
    bool → keep (P, K) bool.  ``top_n`` > 0 stops each scan after that many
    keeps.  One launch, no scratch: the scan keeps its state in shared memory."""
    _check(boxes, "boxes", (torch.float32,), 3)
    _check(valid, "valid", (torch.bool,), 2, boxes.device)
    p, k, four = boxes.shape
    if four != 4 or tuple(valid.shape) != (p, k):
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
    _launch("nms", boxes.device, boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            p, k, float(thresh), int(top_n), _stream(boxes))
    nms_keep_cuda.launches += 1
    return keep


def paste_binarize_cuda(wy: torch.Tensor, masks: torch.Tensor, wxt: torch.Tensor,
                        thresh: float) -> torch.Tensor:
    """(N, H, M) hats × (N, M, M) masks × (N, M, W) hatsᵀ → bool (N, H, W).
    Two launches on the current stream: the in-box column and row ranges of
    each detection's hats into an (N, 4) int32 scratch, then the canvas
    bands."""
    _check(wy, "wy", (torch.float32,), 3)
    _check(masks, "masks", (torch.float32,), 3, wy.device)
    _check(wxt, "wxt", (torch.float32,), 3, wy.device)
    n, h, m = wy.shape
    w = wxt.shape[2]
    if tuple(masks.shape) != (n, m, m) or tuple(wxt.shape[:2]) != (n, m):
        raise ValueError(f"wy {tuple(wy.shape)} / masks {tuple(masks.shape)} / "
                         f"wxt {tuple(wxt.shape)}")
    out = torch.empty((n, h, w), dtype=torch.bool, device=wy.device)
    ext = torch.empty((n, 4), dtype=torch.int32, device=wy.device)
    if out.data_ptr() % 16:
        raise ValueError("the output canvas must be 16-byte aligned")
    _launch("paste_binarize", wy.device, wy.data_ptr(), masks.data_ptr(),
            wxt.data_ptr(), ext.data_ptr(), out.data_ptr(), n, h, w, m, float(thresh),
            _stream(wy))
    paste_binarize_cuda.launches += 1
    return out


def block1_cuda(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor, w2p: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """Fused VGG block 1, all bf16: x (B, H, W, 3) with H, W even → (B, H/2,
    W/2, 64).  The weights come packed by
    ``ops.block1.pack_block1_weights``: w1p (64, 32), w2p (9, 64, 64); b1
    and b2 (64,)."""
    bf = (torch.bfloat16,)
    _check(x, "x", bf, 4)
    b, h, w, c = x.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"x has shape {tuple(x.shape)}: 3 channels and even H, W needed")
    for t, name, shape in ((w1p, "w1p", (64, 32)), (b1, "b1", (64,)),
                           (w2p, "w2p", (9, 64, 64)), (b2, "b2", (64,))):
        _check(t, name, bf, len(shape), x.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if any(t.data_ptr() % 16 for t in (x, w1p, b1, w2p, b2)):
        raise ValueError("x, w1p, b1, w2p and b2 must be 16-byte aligned")
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16, device=x.device)
    _launch("block1", x.device, x.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
            b2.data_ptr(), out.data_ptr(), b, h, w, _stream(x))
    block1_cuda.launches += 1
    return out


def gemm_s8_cuda(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                 bias: torch.Tensor | None, stride: int = 1, padding: int = 0,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """s8 × s8 → s32 on the tensor cores, dequantized to ``out_dtype`` (f32
    or bf16) as ``acc * (xs * ws) + bias``.  A convolution: xq (B, H, W, C)
    int8, wq (Cout, KH, KW, C) int8 (KH = KW), ``stride`` and symmetric
    ``padding``, xs one f32 scale → (B, OH, OW, Cout).  A dense layer: xq
    (M, K) int8, wq (N, K) int8, xs (M, 1) f32 → (M, N).  ws (N,) f32, bias
    (N,) f32 or None.  16-byte loads where C (and K) are multiples of 16,
    else byte loads."""
    conv = xq.dim() == 4
    _check(xq, "xq", (torch.int8,), 4 if conv else 2)
    dev = xq.device
    _check(wq, "wq", (torch.int8,), 4 if conv else 2, dev)
    _check(ws, "ws", (torch.float32,), 1, dev)
    if not isinstance(xs, torch.Tensor) or xs.device != dev or xs.dtype != torch.float32:
        raise ValueError("xs must be an f32 tensor on the device of xq")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    n = wq.shape[0]
    if ws.shape[0] != n:
        raise ValueError(f"ws has shape {tuple(ws.shape)}, wq {tuple(wq.shape)}")
    if bias is not None:
        _check(bias, "bias", (torch.float32,), 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has shape {tuple(bias.shape)}, wq {tuple(wq.shape)}")
    if conv:
        b, h, w, c = xq.shape
        kh, kw = wq.shape[1:3]
        if wq.shape[3] != c or kh != kw:
            raise ValueError(f"wq {tuple(wq.shape)} does not match xq {tuple(xq.shape)}")
        if xs.numel() != 1:
            raise ValueError(f"a convolution takes one activation scale, got {xs.numel()}")
        oh, ow = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
        if stride < 1 or padding < 0 or oh < 1 or ow < 1:
            raise ValueError(f"stride {stride} / padding {padding} for {(h, w)} x {(kh, kw)}")
        out = torch.empty((b, oh, ow, n), dtype=out_dtype, device=dev)
        k = kh * kw * c
    else:
        m, c = xq.shape
        if wq.shape[1] != c:
            raise ValueError(f"wq {tuple(wq.shape)} does not match xq {tuple(xq.shape)}")
        if tuple(xs.shape) != (m, 1) or not xs.is_contiguous():
            raise ValueError(f"xs has shape {tuple(xs.shape)}, expected ({m}, 1) contiguous")
        b, h, w, kh, kw, oh, ow = m, 1, 1, 1, 1, 1, 1
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        k, stride, padding = c, 1, 0
    vec = k % 16 == 0 and (not conv or c % 16 == 0) and not (
        xq.data_ptr() % 16 or wq.data_ptr() % 16)
    _launch("gemm_s8", dev, xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), int(not conv),
            ws.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c, n, kh, kw, stride, padding, oh, ow,
            int(out_dtype == torch.bfloat16), int(not conv), int(vec), _stream(xq))
    gemm_s8_cuda.launches += 1
    return out


KERNELS = (roi_warp_cuda, roi_warp_bwd_cuda, nms_keep_cuda, paste_binarize_cuda, block1_cuda,
           gemm_s8_cuda)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
