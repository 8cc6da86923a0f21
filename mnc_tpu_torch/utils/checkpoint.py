"""The weight bridge, both ways: JAX param trees and ``save_npz`` files ↔ the
port's ``state_dict``, and an npz save/load of the train state.

The JAX package stores conv kernels HWIO and Dense kernels (in, out); the
port's ``nn.Conv2d`` weights are OIHW and ``nn.Linear`` weights (out, in).
Both packages flatten NHWC into ``fc_mask`` and ``fc6``, so a Dense kernel
needs only a transpose, with no row permutation.  A tree path maps to a
parameter name by joining with dots, at any depth (VGG's
``trunk/conv1_1/kernel`` is ``trunk.conv1_1.weight``, ResNet's
``trunk/stage3_block2/bn2/scale`` is ``trunk.stage3_block2.bn2.scale``);
the leaf ``kernel`` is the ``weight``, ``bias`` and ``scale`` keep their
names, and ResNet's convolutions have no bias.  Nothing here imports the
JAX package: ``load_npz`` reads the flat npz that
``mnc_tpu.utils.checkpoint.save_npz`` writes with numpy alone, and
``save_train_state`` writes the parameters under the same flat names
(``params/<module>/.../kernel|bias|scale`` in JAX's layout), so that
package's ``load_npz`` reads them back; the step and the solver state ride
along under ``__meta__/`` and ``__opt__/`` names.  Orbax directories are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params: dict) -> dict:
    """Nested JAX params (``{"params": {"trunk": {"conv1_1": {"kernel",
    "bias"}}, ...}}``, with or without the top ``"params"`` level, numpy or
    array leaves, nested to any depth) → a ``state_dict`` for
    :class:`mnc_tpu_torch.models.mnc.MNC`.
    """
    out = {}

    def walk(prefix: str, tree: dict) -> None:
        for key, v in tree.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(v, dict):
                walk(name, v)
                continue
            a = np.array(v, np.float32)  # a copy: the tensor must own it
            if key == "kernel":
                if a.ndim == 4:  # conv HWIO → OIHW
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:  # Dense (in, out) → Linear (out, in)
                    a = a.T
                else:
                    raise ValueError(f"{name} has shape {a.shape}")
                name = f"{prefix}.weight"
            out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk("", params.get("params", params))
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


def jax_params_from_state_dict(state_dict: dict) -> dict:
    """The reverse bridge: a ``state_dict`` (or any ``{"module....weight" |
    ".bias" | ".scale": tensor}`` mapping, e.g. of gradients) → nested
    ``{"params": {module: {...: {"kernel", "bias", "scale"}}}}`` of f32
    numpy arrays in the JAX package's layout (conv HWIO, Dense (in, out))."""
    tree: dict = {}
    for name, t in state_dict.items():
        *path, kind = name.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if kind == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            kind = "kernel"
        leaf = tree
        for part in path:
            leaf = leaf.setdefault(part, {})
        leaf[kind] = np.ascontiguousarray(a)
    return {"params": tree}


def _flatten(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = tree


def save_train_state(path: str, state) -> None:
    """``TrainState`` → one npz: the parameters as ``save_npz`` names them,
    the momentum traces (and ``iter_size`` accumulators) under ``__opt__/``,
    the step and the solver's counters under ``__meta__/``."""
    flat: dict = {}
    _flatten("params", jax_params_from_state_dict(state.model.state_dict())["params"], flat)
    opt = state.opt.state_dict()
    _flatten("__opt__/trace", jax_params_from_state_dict(opt["trace"])["params"], flat)
    if opt["acc"]:
        _flatten("__opt__/acc", jax_params_from_state_dict(opt["acc"])["params"], flat)
    flat["__meta__/step"] = np.asarray(state.step)
    flat["__meta__/opt_count"] = np.asarray(opt["count"])
    flat["__meta__/opt_mini_step"] = np.asarray(opt["mini_step"])
    flat["__meta__/bbox_pred_normalized"] = np.asarray(True)
    np.savez(path, **flat)


def load_train_state(path: str, state) -> None:
    """Restore what :func:`save_train_state` wrote into ``state`` in place
    (its model and solver must have the same shapes)."""
    tree, meta = load_npz(path)
    opt_tree = tree.pop("__opt__", {})
    state.model.load_state_dict(state_dict_from_jax(tree))
    dev = state.model.device
    opt = {"count": meta["opt_count"], "mini_step": meta["opt_mini_step"],
           "trace": {k: v.to(dev) for k, v in state_dict_from_jax(
               {"params": opt_tree["trace"]}).items()},
           "acc": ({k: v.to(dev) for k, v in state_dict_from_jax(
               {"params": opt_tree["acc"]}).items()} if "acc" in opt_tree else None)}
    state.opt.load_state_dict(opt)
    state.step = int(meta["step"])
