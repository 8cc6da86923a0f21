"""The weights of a configuration, drawn from the seed on the device.

Every parameter of the cascade, named as the port's ``state_dict`` names
it, is cut from one normal draw made on the card by one generator in one
call, and scaled by its kind, in the dtype the model is served in:

- a convolution or dense kernel that feeds a ReLU: He's sqrt(2 / fan_in),
  so activations keep their scale through the depth; the first
  convolution also divided by 64, to take the mean-subtracted pixels to
  units;
- an output layer: a fixed spread of its outputs (logits of RPN scores and
  classes about 2, mask logits about 3, box deltas about 0.2), so that the
  scores, masks and boxes that the cascade selects from are not all ties;
- a bias: 0.1 times a normal;
- a FrozenBN scale 1 + 0.1 n (a block's last one 0.3 + 0.05 n, never 0,
  so every residual branch does work), its bias 0.05 n.

The same tensors are loaded into the port (``load_state_dict``) and handed,
as float32, to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.mnc import RESNET_DEPTHS, VGG16_BLOCKS

_OUT_SPREAD = {"rpn_head.rpn_cls_score": 2.0, "rpn_head.rpn_bbox_pred": 0.2,
               "mask_head.mask_pred": 3.0, "classify_head.cls_score": 2.0,
               "classify_head.bbox_pred": 0.2}


def _conv(name, cin, cout, k, bias=True):
    out = [(f"{name}.weight", (cout, cin, k, k))]
    return out + [(f"{name}.bias", (cout,))] if bias else out


def _bottleneck(name, cin, f, project):
    out = []
    for conv, (ci, co, k) in (("conv1", (cin, f, 1)), ("conv2", (f, f, 3)),
                              ("conv3", (f, 4 * f, 1))):
        out += _conv(f"{name}.{conv}", ci, co, k, False)
        bn = conv.replace("conv", "bn")
        out += [(f"{name}.{bn}.scale", (co,)), (f"{name}.{bn}.bias", (co,))]
    if project:
        out += _conv(f"{name}.proj", cin, 4 * f, 1, False)
        out += [(f"{name}.bn_proj.scale", (4 * f,)), (f"{name}.bn_proj.bias", (4 * f,))]
    return out


def param_spec(net: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in the port's state_dict order."""
    a = len(net["anchor_scales"]) * len(net["anchor_ratios"])
    c, m, p = net["num_classes"], net["mask_size"], net["warp_hw"]
    spec = []
    if net["trunk"] == "vgg16":
        cin = 3
        for block, cout in zip(VGG16_BLOCKS, (64, 128, 256, 512, 512)):
            for name in block:
                spec += _conv(f"trunk.{name}", cin, cout, 3)
                cin = cout
        feat_c = 512
    else:
        depths = RESNET_DEPTHS[int(net["trunk"][len("resnet"):])]
        spec += _conv("trunk.conv1", 3, 64, 7, False)
        spec += [("trunk.bn1.scale", (64,)), ("trunk.bn1.bias", (64,))]
        cin = 64
        for s, (n, f) in enumerate(zip(depths[:3], (64, 128, 256))):
            for i in range(n):
                spec += _bottleneck(f"trunk.stage{s + 2}_block{i}", cin if i == 0 else 4 * f,
                                    f, i == 0)
            cin = 4 * f
        feat_c = 1024
    spec += _conv("rpn_head.rpn_conv", feat_c, 512, 3)
    spec += _conv("rpn_head.rpn_cls_score", 512, 2 * a, 1)
    spec += _conv("rpn_head.rpn_bbox_pred", 512, 4 * a, 1)
    spec += [("mask_head.fc_mask.weight", (net["mask_fc_dim"], p * p * feat_c)),
             ("mask_head.fc_mask.bias", (net["mask_fc_dim"],)),
             ("mask_head.mask_pred.weight", (m * m, net["mask_fc_dim"])),
             ("mask_head.mask_pred.bias", (m * m,))]
    if net["roi_conv5"]:
        depths = RESNET_DEPTHS[int(net["trunk"][len("resnet"):])]
        for i in range(depths[3]):
            spec += _bottleneck(f"classify_head.stage5_block{i}", feat_c if i == 0 else 2048,
                                512, i == 0)
        head_in = 2048
    else:
        pooled = net["pooled_hw"] ** 2 * feat_c
        spec += [("classify_head.fc6.weight", (net["fc_dim"], pooled)),
                 ("classify_head.fc6.bias", (net["fc_dim"],)),
                 ("classify_head.fc7.weight", (net["fc_dim"], net["fc_dim"])),
                 ("classify_head.fc7.bias", (net["fc_dim"],))]
        head_in = net["fc_dim"]
    spec += [("classify_head.cls_score.weight", (c, head_in)),
             ("classify_head.cls_score.bias", (c,)),
             ("classify_head.bbox_pred.weight", (4 * c, head_in)),
             ("classify_head.bbox_pred.bias", (4 * c,))]
    return spec


def _affine(name: str, shape: tuple) -> tuple[float, float]:
    """(a, c): the parameter is a·z + c for standard normal z."""
    layer, leaf = name.rsplit(".", 1)
    if leaf == "scale":
        return (0.05, 0.3) if layer.endswith((".bn3",)) else (0.1, 1.0)
    if leaf == "bias":
        return (0.05, 0.0) if ".bn" in layer else (0.1, 0.0)
    fan_in = math.prod(shape[1:])
    if layer in _OUT_SPREAD:
        return _OUT_SPREAD[layer] / math.sqrt(fan_in), 0.0
    a = math.sqrt(2.0 / fan_in)
    if layer in ("trunk.conv1_1", "trunk.conv1"):
        a /= 64.0
    return a, 0.0


def draw(net: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """name → tensor in ``dtype``, cut from one draw made from ``seed``."""
    spec = param_spec(net)
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        a, c = _affine(name, shape)
        out[name] = flat[off:off + n].view(shape).mul_(a).add_(c).to(dtype)
        off += n
    return out
