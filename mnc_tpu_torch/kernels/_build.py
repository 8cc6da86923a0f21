"""Build and load the port's CUDA kernels (``mnc_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Builds happen at first use, all
sources at once (one ``nvcc`` process each), into ``csrc/build/``, which git
ignores.  A library's file name carries a hash of its source, the flags and
the compiler path, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``--use_fast_math`` is deliberately absent: NMS decisions
and the paste threshold depend on IEEE division and rounding.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (source, C function, argtypes)
KERNEL_ABI = {
    "roi_warp": ("roi_warp.cu", "mnc_roi_warp_fwd",
                 [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "roi_warp_bwd": ("roi_warp_bwd.cu", "mnc_roi_warp_bwd",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "nms": ("nms.cu", "mnc_nms_keep", [_P, _P, _P, _I, _I, _F, _I, _P]),
    "paste_binarize": ("paste.cu", "mnc_paste_binarize",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "block1": ("block1.cu", "mnc_block1", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); it is needed to build "
                           "the CUDA kernels")
    return found


def library_path(name: str, nvcc: str) -> Path:
    src = CSRC / KERNEL_ABI[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel whose library is missing, all in parallel.

    Returns {name: library path}.  Raises with the compiler's output if a
    build fails.  ``nvcc``'s resource report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``<lib>.log``.
    """
    names = list(KERNEL_ABI) if names is None else list(names)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, nvcc) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNEL_ABI[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{log}")
            continue
        paths[n].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def kernel_function(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    path = build([name])[name]
    _, fn_name, argtypes = KERNEL_ABI[name]
    fn = getattr(ctypes.CDLL(str(path)), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
