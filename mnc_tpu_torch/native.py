"""Host-side helpers — port of ``mnc_tpu/native/__init__.py``.

The functions are the port's own C++ library, ``csrc/native.cpp`` (box IoUs
with the Caffe +1 widths, greedy NMS over score-sorted boxes, mask IoUs by
popcount, COCO-style run-length encoding in column-major order whose first
run counts zeros, host mask voting), bound with ``ctypes``.  It is compiled
with ``g++ -O3 -march=native`` at first use into ``csrc/build/`` (git
ignores it); the file name carries a hash of the source, the flags and the
compiler, so an edited source is rebuilt.  Several processes may build at
once: each compiles to a name of its own and renames the result into place.
A failed build raises with the compiler's output; nothing falls back to
numpy.  The numpy versions stay as the plain twins (``*_plain``) that the
tests hold the library against: equal bit for bit, except where
``-march=native`` lets the compiler fuse a multiply and an add into one
rounding (``bbox_overlaps``'s union, the voting sums; an ulp).

The callers are the JAX package's: ``ops/nms_wrapper.py`` (``cpu_nms``),
``data/eval_sds.py`` (``mask_iou_matrix``) and ``tools/serve.py``'s JSON
(``rle_encode``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "native.cpp"
BUILD_DIR = CSRC / "build"
CXX = "g++"  # the compiler: a name on PATH or a path
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libmnc_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library with ``CXX`` unless it is built; returns its path.
    Raises RuntimeError when the compiler is missing or fails (with its
    output)."""
    found = shutil.which(CXX)
    if not found:
        raise RuntimeError(f"C++ compiler {CXX!r} not found; it is needed to build "
                           f"{SOURCE.name}")
    path = library_path(found)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([found, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{found} failed to build {SOURCE.name} (exit "
                               f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c, cf = ctypes.c_int, ctypes.c_float
    sigs = {"bbox_overlaps": ([f32p, c, f32p, c, f32p], None),
            "cpu_nms": ([f32p, c, cf, u8p], c),
            "mask_iou_matrix": ([u8p, c, u8p, c, c, f32p], None),
            "rle_encode": ([u8p, c, c, i32p], c),
            "rle_decode": ([i32p, c, c, c, u8p], None),
            "mask_voting_cpu": ([f32p, c, f32p, c, f32p, f32p, c, cf, f32p], None)}
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _boxes(b) -> np.ndarray:
    return np.ascontiguousarray(b, np.float32).reshape(-1, 4)


def _bits(m) -> np.ndarray:
    """(N, ...) masks → (N, pixels) contiguous uint8 0/1, set where > 0.5."""
    m = np.asarray(m)
    return np.ascontiguousarray(m.reshape(len(m), -1) > 0.5).astype(np.uint8)


# ---- the library ----


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, 4) × (K, 4) boxes → (N, K) f32 IoU (0 where they do not meet)."""
    b, q = _boxes(boxes), _boxes(query)
    out = np.empty((len(b), len(q)), np.float32)
    _lib().bbox_overlaps(b, len(b), q, len(q), out)
    return out


def cpu_nms(sorted_boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Keep mask over score-sorted boxes (reference ``cpu_nms`` semantics)."""
    b = _boxes(sorted_boxes)
    keep = np.empty(len(b), np.uint8)
    _lib().cpu_nms(b, len(b), float(thresh), keep)
    return keep.astype(bool)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, H, W) x (M, H, W) binary masks (set where > 0.5) → (N, M) f32
    IoU; 0 where both are empty."""
    a, b = _bits(a), _bits(b)
    out = np.empty((len(a), len(b)), np.float32)
    _lib().mask_iou_matrix(a, len(a), b, len(b), a.shape[1], out)
    return out


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask (set where > 0.5) → {"size": (H, W), "counts":
    int32 run lengths}, column-major like pycocotools."""
    h, w = mask.shape
    m = np.ascontiguousarray(np.asarray(mask) > 0.5).astype(np.uint8)
    counts = np.empty(h * w + 1, np.int32)
    n = _lib().rle_encode(m, h, w, counts)
    return {"size": (h, w), "counts": counts[:n].copy()}


def rle_decode(rle: dict) -> np.ndarray:
    """Inverse of :func:`rle_encode` → (H, W) uint8; runs past H·W are cut,
    pixels past the last run stay 0."""
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], np.int32)
    out = np.zeros((h, w), np.uint8)
    _lib().rle_decode(counts, len(counts), h, w, out)
    return out


def mask_voting_cpu(kept_boxes, cand_boxes, scores, masks, iou_thresh=0.5):
    """Host mask voting (the oracle of the on-device version): each kept
    box averages the candidate soft masks (M, M) whose box overlaps it by
    IoU >= ``iou_thresh`` and whose score is > 0, each resampled bilinearly
    from its own box frame into the kept frame, weighted by score.
    Returns (K, M, M) f32."""
    kept, cand = _boxes(kept_boxes), _boxes(cand_boxes)
    scores = np.ascontiguousarray(scores, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    ms = masks.shape[-1]
    out = np.empty((len(kept), ms, ms), np.float32)
    _lib().mask_voting_cpu(kept, len(kept), cand, len(cand), scores, masks, ms,
                           float(iou_thresh), out)
    return out


# ---- the plain twins (numpy) ----


def _areas(b: np.ndarray) -> np.ndarray:
    return (b[:, 2] - b[:, 0] + np.float32(1)) * (b[:, 3] - b[:, 1] + np.float32(1))


def bbox_overlaps_plain(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Plain twin of :func:`bbox_overlaps`."""
    b, q = _boxes(boxes), _boxes(query)
    one = np.float32(1)
    iw = np.minimum(b[:, None, 2], q[None, :, 2]) - np.maximum(b[:, None, 0], q[None, :, 0]) + one
    ih = np.minimum(b[:, None, 3], q[None, :, 3]) - np.maximum(b[:, None, 1], q[None, :, 1]) + one
    inter = iw * ih
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / (_areas(b)[:, None] + _areas(q)[None, :] - inter)
    return np.where((iw > 0) & (ih > 0), iou, np.float32(0)).astype(np.float32)


def cpu_nms_plain(sorted_boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Plain twin of :func:`cpu_nms`."""
    b = _boxes(sorted_boxes)
    keep = np.ones(len(b), bool)
    t = np.float32(thresh)
    for i in range(len(b)):
        if keep[i]:
            keep[i + 1:] &= ~(bbox_overlaps_plain(b[i:i + 1], b[i + 1:])[0] > t)
    return keep


def mask_iou_matrix_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain twin of :func:`mask_iou_matrix`.  The pixel counts are sums of
    0/1 products, exact in f32 below 2^24 pixels."""
    a, b = _bits(a).astype(np.float32), _bits(b).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return inter / np.maximum(union, np.float32(1.0))


def rle_encode_plain(mask: np.ndarray) -> dict:
    """Plain twin of :func:`rle_encode`."""
    h, w = mask.shape
    flat = (np.asarray(mask) > 0.5).T.reshape(-1).astype(np.int8)
    if flat.size == 0:
        return {"size": (h, w), "counts": np.zeros(1, np.int32)}
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"size": (h, w), "counts": runs.astype(np.int32)}


def rle_decode_plain(rle: dict) -> np.ndarray:
    """Plain twin of :func:`rle_decode`."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    flat = np.repeat((np.arange(len(counts)) % 2).astype(np.uint8), counts)[:h * w]
    flat = np.concatenate([flat, np.zeros(h * w - len(flat), np.uint8)])
    return np.ascontiguousarray(flat.reshape(w, h).T)


def _hats(coords: np.ndarray, size: int) -> np.ndarray:
    """(..., P) sample coordinates → (..., P, size) bilinear tap weights,
    zero outside [0, size)."""
    d = coords[..., None] - np.arange(size, dtype=np.float32)
    return np.maximum(np.float32(0), np.float32(1) - np.abs(d)).astype(np.float32)


def mask_voting_cpu_plain(kept_boxes, cand_boxes, scores, masks, iou_thresh=0.5):
    """Plain twin of :func:`mask_voting_cpu` (the resample as hat-matrix
    products: the same sums in another order)."""
    kept, cand = _boxes(kept_boxes), _boxes(cand_boxes)
    scores = np.ascontiguousarray(scores, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    ms = masks.shape[-1]
    f1 = np.float32(1)
    iou = bbox_overlaps_plain(kept, cand)
    grid = (np.arange(ms, dtype=np.float32) + np.float32(0.5)) / np.float32(ms)
    cw = np.maximum(cand[:, 2] - cand[:, 0] + f1, f1)
    ch = np.maximum(cand[:, 3] - cand[:, 1] + f1, f1)
    out = np.zeros((len(kept), ms, ms), np.float32)
    for i, kb in enumerate(kept):
        sel = np.flatnonzero((iou[i] >= np.float32(iou_thresh)) & (scores > 0))
        if not len(sel):
            continue
        imy = kb[1] + grid * (kb[3] - kb[1] + f1)
        imx = kb[0] + grid * (kb[2] - kb[0] + f1)
        sy = (imy[None] - cand[sel, 1:2]) / ch[sel, None] * np.float32(ms) - np.float32(0.5)
        sx = (imx[None] - cand[sel, 0:1]) / cw[sel, None] * np.float32(ms) - np.float32(0.5)
        votes = _hats(sy, ms) @ masks[sel] @ _hats(sx, ms).transpose(0, 2, 1)
        acc = np.zeros((ms, ms), np.float32)
        for s, v in zip(scores[sel], votes):
            acc += s * v
        out[i] = acc / scores[sel].sum(dtype=np.float32)
    return out
