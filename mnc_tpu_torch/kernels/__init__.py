"""ctypes wrappers of the port's CUDA kernels, with launch counters.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
returns a CUDA error, and then adds one to its ``launches`` counter — a
plain integer attribute, so a run can show which kernels the main path
went through.  The ops modules call these for CUDA tensors and their plain
PyTorch versions for CPU tensors; nothing here falls back.

    roi_warp_cuda        — kernel A, csrc/roi_warp.cu (replaces roi_warp_pallas)
    roi_warp_bwd_cuda    — kernel A', csrc/roi_warp_bwd.cu (replaces its VJP)
    nms_keep_cuda        — kernel B, csrc/nms.cu      (replaces nms_pallas)
    paste_binarize_cuda  — kernel C, csrc/paste.cu    (replaces paste_binarize_pallas)
    block1_cuda          — kernel D, csrc/block1.cu   (replaces fused_block1)
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
    """(N, H, M) hats × (N, M, M) masks × (N, M, W) hatsᵀ → bool (N, H, W)."""
    _check(wy, "wy", (torch.float32,), 3)
    _check(masks, "masks", (torch.float32,), 3, wy.device)
    _check(wxt, "wxt", (torch.float32,), 3, wy.device)
    n, h, m = wy.shape
    w = wxt.shape[2]
    if tuple(masks.shape) != (n, m, m) or tuple(wxt.shape[:2]) != (n, m):
        raise ValueError(f"wy {tuple(wy.shape)} / masks {tuple(masks.shape)} / "
                         f"wxt {tuple(wxt.shape)}")
    out = torch.empty((n, h, w), dtype=torch.bool, device=wy.device)
    _launch("paste_binarize", wy.device, wy.data_ptr(), masks.data_ptr(),
            wxt.data_ptr(), out.data_ptr(), n, h, w, m, float(thresh), _stream(wy))
    paste_binarize_cuda.launches += 1
    return out


def block1_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """Fused VGG block 1, all bf16: x (B, H, W, 3), w1 (3, 3, 3, 64) and w2
    (3, 3, 64, 64) in HWIO order, b1 and b2 (64,) → (B, H/2, W/2, 64)."""
    bf = (torch.bfloat16,)
    _check(x, "x", bf, 4)
    for t, name, shape in ((w1, "w1", (3, 3, 3, 64)), (b1, "b1", (64,)),
                           (w2, "w2", (3, 3, 64, 64)), (b2, "b2", (64,))):
        _check(t, name, bf, len(shape), x.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    b, h, w, c = x.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"x has shape {tuple(x.shape)}: 3 channels and even H, W needed")
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16, device=x.device)
    _launch("block1", x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), b, h, w, _stream(x))
    block1_cuda.launches += 1
    return out


KERNELS = (roi_warp_cuda, roi_warp_bwd_cuda, nms_keep_cuda, paste_binarize_cuda, block1_cuda)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
