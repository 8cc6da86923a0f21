"""Pretrained ResNet weights from a torchvision state dict — port of
``fold_bn`` and ``load_resnet_torchvision`` from ``mnc_tpu/utils/weights.py``.

BatchNorm's running statistics fold into the FrozenBN affine (scale =
γ/√(σ²+ε), bias = β − μ·scale).  torchvision's ``layer1..3`` become the
trunk's ``stage2..4``; ``layer4`` becomes the per-RoI conv5 head
(``classify_head.stage5_block*``) when the model has one.  torchvision's
convolutions are OIHW like the port's, so they are copied as they are; only
the stem is adapted to the MNC input convention.  Nothing is downloaded:
the state dict is given, or read from a local file.
"""

from __future__ import annotations

import numpy as np
import torch

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.models.resnet import _DEPTHS

# ImageNet RGB normalization that torchvision's models expect
_TV_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_TV_STD = np.array([0.229, 0.224, 0.225], np.float32)

_BN_EPS = 1e-5  # torch BatchNorm2d's default; torchvision's ResNets keep it


def fold_bn(gamma, beta, mean, var, eps: float = _BN_EPS):
    """BatchNorm statistics → the FrozenBN affine (scale, bias), f32 numpy:
    γ·(x − μ)/√(σ²+ε) + β ≡ x·scale + bias."""
    scale = np.asarray(gamma, np.float32) / np.sqrt(np.asarray(var, np.float32) + eps)
    bias = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale
    return scale, bias


def _np(state_dict: dict) -> dict:
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in state_dict.items()}


def load_resnet_torchvision(params: dict, state_dict: dict | None = None,
                            weights_path: str | None = None, depth: int = 101,
                            adapt_input: bool = True) -> dict:
    """Merge a torchvision ResNet state dict into ``params`` (a port
    ``state_dict``, e.g. ``MNC(...).state_dict()``); returns the merged copy
    for ``load_state_dict``.  ``weights_path`` names a local ``torch.save``
    file, read when ``state_dict`` is not given.

    ``adapt_input`` adapts the stem to the MNC input convention: torchvision
    expects RGB scaled by 1/255 and normalized by ImageNet's mean and std,
    MNC feeds BGR with the pixel means subtracted; the stem conv is scaled
    and its input channels reversed, and the constant offset that is left is
    folded into ``bn1``'s bias (the stem conv has none).  Without it the stem
    is copied as it is.

    Geometry: torchvision's resnet50/101/152 are v1.5 (stride on the 3×3),
    so the model must be built with ``resnet_stride_in_3x3=True``; the stride
    lives in the module, not in the weights, so a mismatch cannot be seen
    here.
    """
    if state_dict is None:
        if not weights_path:
            raise ValueError("state_dict or weights_path is required")
        state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    sd = _np(state_dict)
    out = {k: v.clone() for k, v in params.items()}

    def put(name: str, value: np.ndarray) -> None:
        if name not in out:
            raise KeyError(f"{name} is not a parameter of the model")
        if tuple(out[name].shape) != value.shape:
            raise ValueError(f"{name}: model {tuple(out[name].shape)}, weights {value.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).to(out[name])

    def put_bn(dst: str, src: str, offset=None) -> None:
        scale, bias = fold_bn(sd[f"{src}.weight"], sd[f"{src}.bias"],
                              sd[f"{src}.running_mean"], sd[f"{src}.running_var"])
        put(f"{dst}.scale", scale)
        put(f"{dst}.bias", bias if offset is None else bias + scale * offset)

    def put_block(dst: str, src: str) -> None:
        for j in (1, 2, 3):
            put(f"{dst}.conv{j}.weight", sd[f"{src}.conv{j}.weight"])
            put_bn(f"{dst}.bn{j}", f"{src}.bn{j}")
        if f"{src}.downsample.0.weight" in sd:
            put(f"{dst}.proj.weight", sd[f"{src}.downsample.0.weight"])
            put_bn(f"{dst}.bn_proj", f"{src}.downsample.1")

    w = sd["conv1.weight"]  # (64, 3, 7, 7), RGB
    offset = None
    if adapt_input:
        pm_rgb = np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(3)[::-1]
        delta = (pm_rgb / 255.0 - _TV_MEAN) / _TV_STD
        offset = np.einsum("oikl,i->o", w, delta)  # the constant shift before bn1
        w = (w / (255.0 * _TV_STD[None, :, None, None]))[:, ::-1]  # RGB → BGR
    put("trunk.conv1.weight", w)
    put_bn("trunk.bn1", "bn1", offset)
    blocks = _DEPTHS[depth]
    for layer, n_blocks in enumerate(blocks[:3]):
        for i in range(n_blocks):
            put_block(f"trunk.stage{layer + 2}_block{i}", f"layer{layer + 1}.{i}")
    if "classify_head.stage5_block0.conv1.weight" in out:  # NET.ROI_CONV5
        for i in range(blocks[3]):
            put_block(f"classify_head.stage5_block{i}", f"layer4.{i}")
    return out
