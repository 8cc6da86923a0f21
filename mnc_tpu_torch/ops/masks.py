"""Mask geometry — port of ``mnc_tpu/ops/masks.py``: the training-side
``intersect_mask`` (crop a gt instance mask to an RoI and resize it to
MASK_SIZE, in plain f32) and the canvas paste-back of soft masks.

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

from mnc_tpu_torch.ops.roi_warp import interp_matrix, unit_grid


def _box_grid_centers(boxes: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """(..., P) continuous source coords of P bin centers spanning each of
    the (..., 4) boxes along one axis (0 = y, 1 = x)."""
    lo = boxes[..., 1] if axis == 0 else boxes[..., 0]
    hi = boxes[..., 3] if axis == 0 else boxes[..., 2]
    span = hi - lo + 1.0
    grid = unit_grid(out_size, boxes.device)
    return lo.unsqueeze(-1) + grid * span.unsqueeze(-1) - 0.5


def intersect_mask(rois: torch.Tensor, gt_boxes: torch.Tensor, gt_masks: torch.Tensor,
                   mask_size: int, binarize: bool = True) -> torch.Tensor:
    """Mask regression targets: crop each gt mask to an RoI, resize to M×M.

    rois (..., N, 4) sampled RoIs, gt_boxes (..., N, 4) the matched gt box
    per RoI, gt_masks (..., N, S, S) the matched gt mask per RoI, stored
    gt-box-cropped (the maskdb convention).  Returns (..., N, M, M) f32,
    thresholded at ``>= 0.5`` when ``binarize``; RoI area outside the gt box
    is 0.  The product runs in full f32 (no TF32).
    """
    s = gt_masks.shape[-1]
    # RoI bin centers in image coords, then into gt-box-normalized mask coords
    yc_img = _box_grid_centers(rois, mask_size, 0) + 0.5  # undo the -0.5 pixel shift
    xc_img = _box_grid_centers(rois, mask_size, 1) + 0.5
    gh = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gw = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    yc = (yc_img - gt_boxes[..., 1:2]) / gh.unsqueeze(-1) * s - 0.5
    xc = (xc_img - gt_boxes[..., 0:1]) / gw.unsqueeze(-1) * s - 0.5
    wy = interp_matrix(yc, s)  # (..., N, M, S); rows vanish outside the gt box
    wx = interp_matrix(xc, s)
    out = wy @ gt_masks.to(wy.dtype) @ wx.transpose(-1, -2)
    if binarize:
        out = (out >= 0.5).to(torch.float32)
    return out


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
