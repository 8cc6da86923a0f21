"""The one generator of traffic: a pool of distinct requests from a mix's
parameters and the seed.

A mix (``portbench/traffic/<name>.json``) gives the canvases a request holds,
the size of the pool that the closed loop cycles through, and the set of
photo sizes.  Every seed serves the same multiset of photo sizes, in an
order that the seed shuffles, so that seeds change the pictures and not the
amount of work.  Each photo is scaled as ``utils/blob.py`` scales a test
image (the short side to ``short_side``, the long side at most
``max_side``) and placed at the top left of the zero canvas; its pixels are
a smooth random field with fine noise, made on the device from the seed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Pool:
    canvases: torch.Tensor  # (P, B, H, W, 3) uint8, pinned host memory on a card
    im_info: torch.Tensor  # (P, B, 3) f32 (scaled h, scaled w, scale), likewise


def scaled_size(h0: int, w0: int, short_side: int, max_side: int):
    """(scaled h, scaled w, scale) of a photo, as the reference tester scales."""
    scale = float(short_side) / min(h0, w0)
    if round(scale * max(h0, w0)) > max_side:
        scale = float(max_side) / max(h0, w0)
    return round(h0 * scale), round(w0 * scale), scale


def make_pool(traffic: dict, canvas_hw, seed: int, device) -> Pool:
    p, b = traffic["pool_requests"], traffic["canvases_per_request"]
    sizes = traffic["photo_sizes"]
    n = p * b
    gen = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(n, generator=gen, device=device).tolist()
    photos = [tuple(sizes[i % len(sizes)]) for i in order]
    h, w = canvas_hw
    canvases = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=device)
    info = torch.zeros((n, 3), dtype=torch.float32)
    for i, (h0, w0) in enumerate(photos):
        hs, ws, scale = scaled_size(h0, w0, traffic["short_side"], traffic["max_side"])
        if hs > h or ws > w:
            raise ValueError(f"a {h0}x{w0} photo scales to {hs}x{ws}, beyond the canvas")
        coarse = torch.rand((1, 3, -(-hs // 32) + 1, -(-ws // 32) + 1), generator=gen,
                            device=device)
        img = F.interpolate(coarse, size=(hs, ws), mode="bilinear", align_corners=False)
        img = img * 255.0 + 12.0 * torch.randn((1, 3, hs, ws), generator=gen, device=device)
        canvases[i, :hs, :ws] = img.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
        info[i] = torch.tensor([hs, ws, scale])
    canvases = canvases.reshape(p, b, h, w, 3)
    info = info.reshape(p, b, 3)
    pin = torch.device(device).type == "cuda"
    host = torch.empty(canvases.shape, dtype=torch.uint8, pin_memory=pin)
    host.copy_(canvases)
    return Pool(host, info.pin_memory() if pin else info)
