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
along under ``__meta__/`` and ``__opt__/`` names.  The JAX package's orbax
step directories become step directories holding that npz
(``save_checkpoint``, ``latest_checkpoint``, ``restore_checkpoint``,
``restore_latest``).

On JAX-layout trees (numpy leaves) it also carries the rest of that
package's npz checkpoint: ``save_npz`` / ``npz_meta`` / ``arch_for_npz``,
the reference snapshot's bbox fold (``export_params``) and its inverse
(``renormalize_bbox_pred``), and ``load_import_weights``, the shared
``--caffemodel`` / ``--npz`` handling of the entry points.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import os.path as osp
import shutil

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


# --------------------------------------------------------------------------- #
# Step directories (≙ the orbax functions of mnc_tpu/utils/checkpoint.py)
# --------------------------------------------------------------------------- #

STATE_FILE = "train_state.npz"


def _is_complete(name: str) -> bool:
    return name.startswith("ckpt_") and not name.endswith("-tmp")


def save_checkpoint(directory: str, state, step: int | None = None, keep: int = 5) -> str:
    """Save ``state`` (:func:`save_train_state`) as
    ``<directory>/ckpt_<step:08d>/train_state.npz`` and keep the newest
    ``keep`` checkpoints.  The step directory is written as ``...-tmp`` and
    renamed when complete, so a crash leaves no directory that
    :func:`latest_checkpoint` would pick; stale ``-tmp`` ones are removed
    here."""
    step = int(state.step) if step is None else int(step)
    os.makedirs(directory, exist_ok=True)
    path = osp.join(directory, f"ckpt_{step:08d}")
    tmp = path + "-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_train_state(osp.join(tmp, STATE_FILE), state)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    names = os.listdir(directory)
    complete = sorted(n for n in names if _is_complete(n))
    stale = [n for n in names if n.startswith("ckpt_") and n.endswith("-tmp")]
    for n in complete[:-keep] + stale:
        shutil.rmtree(osp.join(directory, n), ignore_errors=True)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The newest complete ``ckpt_*`` directory under ``directory`` (None
    if there is none)."""
    if not osp.isdir(directory):
        return None
    cks = sorted(n for n in os.listdir(directory) if _is_complete(n))
    return osp.join(directory, cks[-1]) if cks else None


def checkpoint_npz(path: str) -> str:
    """A ``--ckpt`` argument → the npz to read: a step directory's state
    file, or that of the newest step under a run directory."""
    if osp.isdir(path) and not osp.basename(osp.normpath(path)).startswith("ckpt_"):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = found
    return osp.join(path, STATE_FILE) if osp.isdir(path) else path


def restore_checkpoint(path: str, state):
    """Restore a step directory (or its npz) into ``state`` in place and
    return it."""
    load_train_state(checkpoint_npz(path), state)
    return state


def restore_latest(directory: str, state):
    """Resume from the newest checkpoint under ``directory``: (state, step),
    ``state`` untouched and step 0 when there is none."""
    path = latest_checkpoint(directory)
    if path is None:
        return state, 0
    restore_checkpoint(path, state)
    return state, int(state.step)


# --------------------------------------------------------------------------- #
# npz export and import on JAX-layout trees (≙ mnc_tpu/utils/checkpoint.py)
# --------------------------------------------------------------------------- #


def _bbox_stats(tree: dict, bbox_means, bbox_stds):
    bb = tree["params"]["classify_head"]["bbox_pred"]
    k, b = np.asarray(bb["kernel"]), np.asarray(bb["bias"])
    reps = k.shape[-1] // 4
    return (bb, k, b, np.tile(np.asarray(bbox_means, np.float32), reps),
            np.tile(np.asarray(bbox_stds, np.float32), reps))


def export_params(params: dict, bbox_means, bbox_stds) -> dict:
    """Fold the bbox-target normalization into ``bbox_pred`` (a copy):
    kernel' = kernel·stds, bias' = bias·stds + means per output, so the
    classify head emits UN-normalized deltas, as a reference ``.caffemodel``
    snapshot does (run it with ``bbox_pred_normalized=False``)."""
    params = copy.deepcopy(params)
    bb, k, b, means, stds = _bbox_stats(params, bbox_means, bbox_stds)
    bb["kernel"] = k * stds[None, :]
    bb["bias"] = b * stds + means
    return params


def renormalize_bbox_pred(params: dict, bbox_means, bbox_stds) -> dict:
    """Inverse of :func:`export_params` (a copy): kernel' = kernel / stds,
    bias' = (bias − means) / stds — what fine-tuning from a reference
    snapshot needs, since training regresses normalized deltas."""
    params = copy.deepcopy(params)
    bb, k, b, means, stds = _bbox_stats(params, bbox_means, bbox_stds)
    bb["kernel"] = k / stds[None, :]
    bb["bias"] = (b - means) / stds
    return params


def save_npz(path: str, params: dict, meta: dict | None = None) -> None:
    """Flat-name npz export (``trunk/conv1_1/kernel`` ...), ``meta`` under
    ``__meta__/<key>`` — e.g. ``bbox_pred_normalized``: True while the stats
    are still out of the regressor, False once :func:`export_params` folded
    them in."""
    flat: dict = {}
    for k, v in params.items():
        _flatten(k, v, flat)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    for k, v in (meta or {}).items():
        flat[f"__meta__/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def npz_meta(path: str) -> dict:
    """The ``__meta__/*`` entries of an npz export ({} for older files)."""
    return load_npz(path)[1]


def arch_for_npz(path: str, arch):
    """``arch`` with ``bbox_pred_normalized`` set from the npz's metadata
    (files without it are taken as normalized, the training convention)."""
    normalized = bool(npz_meta(path).get("bbox_pred_normalized", True))
    if normalized == arch.bbox_pred_normalized:
        return arch
    return dataclasses.replace(arch, bbox_pred_normalized=normalized)


def parse_remap(pairs) -> dict:
    """['old=new', ...] (the --remap CLI form) → {old: new}."""
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise ValueError(f"--remap entries are old=new, got {p!r}")
        old, new = p.split("=", 1)
        out[old] = new
    return out


def load_import_weights(caffemodel_path, npz_path, arch, params, remap=None,
                        make_params=None):
    """Shared --caffemodel / --npz handling of the entry points → (params,
    arch), params a JAX-layout tree.

    A caffemodel flips ``bbox_pred_normalized`` (snapshot weights predict
    raw deltas) and ``suppress_untrainable_anchors`` (the reference scored
    every anchor) off, and auto-configures the fields its blob shapes
    determine (mask size, classes, fc widths, warp size:
    ``infer_arch_overrides``); ``make_params(arch) -> params`` re-initializes
    the tree when that changes head shapes, and without it such an import
    raises.  An npz carries the normalization state in its metadata; the
    solver state of a ``save_train_state`` file is left out.  ``remap``
    ({source_layer: canonical_layer} or ['old=new', ...]) renames caffemodel
    layers before matching.  Rebuild the model iff the arch changed."""
    if caffemodel_path:
        from mnc_tpu_torch.utils.caffemodel import (infer_arch_overrides,
                                                    load_mnc_caffemodel,
                                                    read_caffemodel)

        if isinstance(remap, (list, tuple)):
            remap = parse_remap(remap)
        blobs = read_caffemodel(caffemodel_path)
        named = {remap.get(k, k): v for k, v in blobs.items()} if remap else blobs
        changes = {k: v for k, v in infer_arch_overrides(named).items()
                   if getattr(arch, k) != v}
        if changes:
            print(f"caffemodel auto-config: {changes} "
                  f"(was {({k: getattr(arch, k) for k in changes})})")
            arch = dataclasses.replace(arch, **changes)
            if make_params is None:
                raise ValueError(
                    f"caffemodel {caffemodel_path} needs arch overrides {changes} but no "
                    "make_params re-init hook was given")
            params = make_params(arch)
        params = load_mnc_caffemodel(caffemodel_path, params, remap=remap, blobs=blobs)
        arch = dataclasses.replace(arch, bbox_pred_normalized=False,
                                   suppress_untrainable_anchors=False)
        print(f"loaded reference weights from {caffemodel_path} "
              "(stage-bridge de-norm off; anchor-type suppression off)")
    elif npz_path:
        tree, _ = load_npz(npz_path)
        params = {k: v for k, v in tree.items() if k != "__opt__"}
        new_arch = arch_for_npz(npz_path, arch)
        if new_arch is not arch:
            print("npz has bbox stats folded in; stage bridge de-norm off")
        arch = new_arch
    return params, arch
