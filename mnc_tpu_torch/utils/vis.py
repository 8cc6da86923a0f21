"""Instance-mask visualization — port of ``mnc_tpu/utils/vis.py`` (the
reference's ``vis_seg`` demo overlays).  ``cv2`` is imported only for the
optional labels, and skipped where it is missing."""

from __future__ import annotations

import numpy as np

# VOC-style class palette (21 entries, BGR)
_PALETTE = np.array([
    (0, 0, 0), (0, 0, 128), (0, 128, 0), (0, 128, 128), (128, 0, 0),
    (128, 0, 128), (128, 128, 0), (128, 128, 128), (0, 0, 64), (0, 0, 192),
    (0, 128, 64), (0, 128, 192), (128, 0, 64), (128, 0, 192), (128, 128, 64),
    (128, 128, 192), (0, 64, 0), (0, 64, 128), (0, 192, 0), (0, 192, 128),
    (128, 64, 0),
], np.float32)


def vis_seg(image_bgr: np.ndarray, dets: dict, class_names=None,
            score_thresh: float = 0.7, alpha: float = 0.5) -> np.ndarray:
    """Overlay detected instance masks + boxes on a BGR image.

    ``dets`` is a host-side ``MNCPipeline.detect()`` output (needs full_masks).
    Returns the annotated BGR uint8 image.
    """
    out = image_bgr.astype(np.float32).copy()
    n = len(dets["scores"])
    labels = []
    for i in range(n):
        if not dets["valid"][i] or dets["scores"][i] < score_thresh:
            continue
        cls = int(dets["classes"][i])
        color = _PALETTE[cls % len(_PALETTE)]
        mask = dets["full_masks"][i].astype(bool)
        out[mask] = out[mask] * (1 - alpha) + color[None, :] * alpha
        x1, y1, x2, y2 = dets["boxes"][i].astype(int)
        x1, y1 = max(x1, 0), max(y1, 0)
        x2 = min(x2, out.shape[1] - 1)
        y2 = min(y2, out.shape[0] - 1)
        out[y1:y2 + 1, [x1, x2]] = color
        out[[y1, y2], x1:x2 + 1] = color
        name = class_names[cls] if class_names else str(cls)
        labels.append((f"{name} {dets['scores'][i]:.2f}", (x1, max(y1 - 4, 10)),
                       color.tolist()))
    img8 = np.clip(out, 0, 255).astype(np.uint8)
    try:
        import cv2

        for text, org, color in labels:  # putText needs uint8
            cv2.putText(img8, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    except ImportError:
        pass
    return img8
