"""The weight bridge: JAX param trees and ``save_npz`` files → the port's
``state_dict``.

The JAX package stores conv kernels HWIO and Dense kernels (in, out); the
port's ``nn.Conv2d`` weights are OIHW and ``nn.Linear`` weights (out, in).
Both packages flatten NHWC into ``fc_mask`` and ``fc6``, so a Dense kernel
needs only a transpose, with no row permutation.  Nothing here imports the
JAX package: ``load_npz`` reads the flat npz that
``mnc_tpu.utils.checkpoint.save_npz`` writes with numpy alone.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params: dict) -> dict:
    """Nested JAX params (``{"params": {"trunk": {"conv1_1": {"kernel",
    "bias"}}, ...}}``, with or without the top ``"params"`` level, numpy or
    array leaves) → a ``state_dict`` for :class:`mnc_tpu_torch.models.mnc.MNC`.
    """
    tree = params.get("params", params)
    out = {}
    for module, layers in tree.items():
        for layer, leaves in layers.items():
            kernel = np.asarray(leaves["kernel"], np.float32)
            if kernel.ndim == 4:  # conv HWIO → OIHW
                weight = kernel.transpose(3, 2, 0, 1)
            elif kernel.ndim == 2:  # Dense (in, out) → Linear (out, in)
                weight = kernel.T
            else:
                raise ValueError(f"{module}/{layer}/kernel has shape {kernel.shape}")
            out[f"{module}.{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
            out[f"{module}.{layer}.bias"] = torch.from_numpy(
                np.asarray(leaves["bias"], np.float32).copy())
    return out


def load_npz(path: str) -> tuple[dict, dict]:
    """A ``save_npz`` file → (nested params dict, meta dict).

    ``meta`` holds the ``__meta__/*`` entries as Python scalars, e.g.
    ``bbox_pred_normalized`` (False when the bbox stats are folded into the
    weights, so the stage bridge must not re-apply them: pass it to
    ``MNCArch(bbox_pred_normalized=...)``)."""
    params: dict = {}
    meta: dict = {}
    with np.load(path) as data:
        for name in data.files:
            v = data[name]
            if name.startswith("__meta__/"):
                meta[name.split("/", 1)[1]] = v.item() if v.ndim == 0 else v
                continue
            parts = name.split("/")
            d = params
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
    return params, meta
