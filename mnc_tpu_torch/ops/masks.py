"""Canvas paste-back of soft masks — port of the unmold half of
``mnc_tpu/ops/masks.py``.

Per instance, the paste is the hat-matrix pair  out = Wy @ mask @ Wxᵀ
restricted to the box, then ``> thresh``.  A CUDA tensor goes to kernel C
(``csrc/paste.cu``, which keeps the float product on chip and writes only
the boolean canvas); a CPU tensor goes to :func:`paste_binarize_plain`.  The
hats come from :func:`_paste_axis_weights` on either device, so both share
every geometric convention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mnc_tpu_torch.ops.roi_warp import interp_matrix


def _paste_axis_weights(lo: torch.Tensor, hi: torch.Tensor, m: int,
                        out_len: int) -> torch.Tensor:
    """(..., out_len, M) hat weights mapping M mask samples onto canvas
    pixels [0, out_len) for boxes spanning [lo, hi] (shapes (...,))."""
    span = hi - lo + 1.0
    pix = torch.arange(out_len, dtype=torch.float32, device=lo.device)
    t = (pix - lo.unsqueeze(-1) + 0.5) / span.unsqueeze(-1)
    coord = t * m - 0.5  # (..., out_len)
    wmat = interp_matrix(coord, m)  # (..., out_len, M)
    inside = (t >= 0.0) & (t < 1.0)
    # clamp edge samples (the reference resize replicates edges in the box);
    # argmin takes the first minimum, as jnp.argmin does
    wsum = wmat.sum(-1, keepdim=True)
    src = torch.arange(m, dtype=torch.float32, device=lo.device)
    edge = (coord.unsqueeze(-1) - src).abs().argmin(-1)
    wmat = torch.where((wsum > 0.0) | ~inside.unsqueeze(-1), wmat,
                       F.one_hot(edge, m).to(torch.float32))
    return wmat * inside.unsqueeze(-1).to(torch.float32)


def paste_binarize_plain(wy: torch.Tensor, masks: torch.Tensor, wxt: torch.Tensor,
                         thresh: float) -> torch.Tensor:
    """Plain twin of kernel C: (N, H, M) × (N, M, M) × (N, M, W) in f32,
    then ``> thresh`` → bool (N, H, W)."""
    return torch.bmm(torch.bmm(wy, masks), wxt) > thresh


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, canvas_hw: tuple[int, int],
                binarize_thresh: float) -> torch.Tensor:
    """Unmold (..., M, M) soft masks in box frames into bool (..., H, W)
    canvases for (..., 4) image-coordinate boxes, binarized at
    ``> binarize_thresh`` (reference BINARIZE_THRESH = 0.4), in f32."""
    h, w = canvas_hw
    m = masks.shape[-1]
    lead = masks.shape[:-2]
    boxes = boxes.reshape(-1, 4).float()
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], m, h)  # (N, H, M)
    wxt = _paste_axis_weights(boxes[:, 0], boxes[:, 2], m, w).transpose(1, 2)
    masks = masks.reshape(-1, m, m).float()
    if masks.is_cuda:
        from mnc_tpu_torch.kernels import paste_binarize_cuda

        out = paste_binarize_cuda(wy.contiguous(), masks.contiguous(),
                                  wxt.contiguous(), binarize_thresh)
    else:
        out = paste_binarize_plain(wy, masks, wxt, binarize_thresh)
    return out.reshape(*lead, h, w)
