"""Anchor generation.

Behavioral port of the reference ``lib/transform/anchors.py`` (generate_anchors:
9 base anchors = 3 scales x 3 ratios around a stride-16 base box), plus the
grid-shifting that the reference's AnchorTargetLayer / ProposalLayer
(``lib/pylayer/anchor_target_layer.py``, ``lib/pylayer/proposal_layer.py``)
performed per-call on the host with numpy.  The full shifted anchor set is
built once per canvas and kept on the device as a buffer of the model.

Conventions match the reference exactly: boxes are (x1, y1, x2, y2) in pixels,
widths measured with the Caffe +1 convention (w = x2 - x1 + 1), anchors centered
on ``(stride-1)/2``.
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr) -> np.ndarray:
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def _ratio_enum(anchor: np.ndarray, ratios) -> np.ndarray:
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / np.asarray(ratios, dtype=np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor: np.ndarray, scales) -> np.ndarray:
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * np.asarray(scales, dtype=np.float64)
    hs = h * np.asarray(scales, dtype=np.float64)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def generate_anchors(
    base_size: int = 16,
    ratios=(0.5, 1.0, 2.0),
    scales=(8, 16, 32),
) -> np.ndarray:
    """Base anchors (A, 4) by enumerating aspect ratios x scales of a base box.

    Identical numerics to the reference generate_anchors (the canonical
    py-faster-rcnn implementation MNC inherits).
    """
    base_anchor = np.array([0, 0, base_size - 1, base_size - 1], dtype=np.float64)
    ratio_anchors = _ratio_enum(base_anchor, ratios)
    return np.vstack(
        [_scale_enum(ratio_anchors[i, :], scales) for i in range(ratio_anchors.shape[0])]
    ).astype(np.float32)


def shifted_anchors(
    feat_h: int,
    feat_w: int,
    stride: int = 16,
    ratios=(0.5, 1.0, 2.0),
    scales=(8, 16, 32),
) -> np.ndarray:
    """All anchors over a (feat_h, feat_w) grid: (feat_h*feat_w*A, 4) float32.

    Row-major over (y, x, anchor) — matching the reference's reshape order
    (anchors vary fastest), so downstream score reshapes line up.
    """
    base = generate_anchors(base_size=stride, ratios=ratios, scales=scales)
    shift_x = np.arange(feat_w) * stride
    shift_y = np.arange(feat_h) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = base[None, :, :] + shifts[:, None, :].astype(np.float32)
    return all_anchors.reshape(-1, 4).astype(np.float32)
