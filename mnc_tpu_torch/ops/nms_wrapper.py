"""Host NMS — port of ``mnc_tpu/ops/nms_wrapper.py`` (≙ reference
``lib/nms/nms_wrapper.py``): ``nms(dets, thresh)`` over (N, 5) [x1, y1, x2,
y2, score] arrays, returning kept indices, on the host through
``mnc_tpu_torch.native.cpu_nms``.  The device path is ``ops/nms.py``.
"""

from __future__ import annotations

import numpy as np

from mnc_tpu_torch import native


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS over (N, 5) dets; returns kept indices in score order
    (equal scores keep the lower index first)."""
    if len(dets) == 0:
        return np.zeros((0,), np.int64)
    boxes = np.ascontiguousarray(dets[:, :4], np.float32)
    order = np.argsort(-np.asarray(dets[:, 4], np.float32), kind="stable")
    return order[native.cpu_nms(boxes[order], float(thresh))]


def apply_nms(all_boxes: list, thresh: float) -> list:
    """Per-class, per-image NMS over the reference's all_boxes structure
    (all_boxes[cls][img] = (N, 5) array)."""
    out = [[[] for _ in range(len(cls_boxes))] for cls_boxes in all_boxes]
    for c, cls_boxes in enumerate(all_boxes):
        for i, dets in enumerate(cls_boxes):
            dets = np.asarray(dets)
            if dets.size == 0:
                continue
            out[c][i] = dets[nms(dets, thresh)]
    return out
