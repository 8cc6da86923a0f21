"""Synthetic "shapes" instance-segmentation dataset — the port's own numpy
copy of ``mnc_tpu/data/synthetic.py`` (same seeds, same examples), enough to
feed the train step with no external data.

Each image is a noisy background with N instances of C-1 shape classes
(rectangle / ellipse / triangle / cross / diamond), each drawn in a
class-correlated color.  Ground-truth masks are stored gt-box-cropped at a
fixed (S, S) resolution — the maskdb convention that
``mnc_tpu_torch.ops.masks.intersect_mask`` consumes.
"""

from __future__ import annotations

import numpy as np

SHAPE_NAMES = ("rectangle", "ellipse", "triangle", "cross", "diamond")


def _render_shape(kind: int, h: int, w: int) -> np.ndarray:
    """Binary (h, w) mask of the shape filling its bounding box."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    y = (yy + 0.5) / h * 2 - 1  # [-1, 1]
    x = (xx + 0.5) / w * 2 - 1
    if kind == 0:  # rectangle
        m = np.ones((h, w), bool)
    elif kind == 1:  # ellipse
        m = x * x + y * y <= 1.0
    elif kind == 2:  # triangle (apex up)
        m = (y >= -1) & (np.abs(x) <= (y + 1) / 2)
    elif kind == 3:  # cross
        m = (np.abs(x) <= 0.34) | (np.abs(y) <= 0.34)
    else:  # diamond
        m = np.abs(x) + np.abs(y) <= 1.0
    return m.astype(np.float32)


class SyntheticShapes:
    """Generator of fixed-shape training examples.

    Args:
      canvas_hw: static image canvas (H, W).
      num_classes: total classes incl. background (≤ 1 + len(SHAPE_NAMES)).
      max_gt: gt padding count.
      gt_mask_size: stored gt mask resolution S.
      n_range: (min, max] instances per image.
      seed: base RNG seed; example i is deterministic given (seed, i).
    """

    def __init__(self, canvas_hw=(128, 160), num_classes=6, max_gt=8,
                 gt_mask_size=28, n_range=(2, 5), seed=0, num_images=64):
        assert 2 <= num_classes <= 1 + len(SHAPE_NAMES)
        self.canvas_hw = canvas_hw
        self.num_classes = num_classes
        self.max_gt = max_gt
        self.gt_mask_size = gt_mask_size
        self.n_range = n_range
        self.seed = seed
        self.num_images = num_images
        # deterministic class colors (BGR-ish, centered around 0 post-mean-sub)
        cr = np.random.RandomState(1234)
        self.colors = cr.uniform(-90, 90, size=(num_classes, 3)).astype(np.float32)

    def __len__(self):
        return self.num_images

    def example(self, index: int) -> dict:
        rs = np.random.RandomState((self.seed * 100003 + index) % (2**31))
        h, w = self.canvas_hw
        s = self.gt_mask_size
        img = rs.normal(0.0, 8.0, size=(h, w, 3)).astype(np.float32)

        n = rs.randint(self.n_range[0], self.n_range[1] + 1)
        n = min(n, self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_classes = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        gt_masks = np.zeros((self.max_gt, s, s), np.float32)

        for i in range(n):
            cls = rs.randint(1, self.num_classes)
            bw = rs.randint(max(12, w // 10), w // 2)
            bh = rs.randint(max(12, h // 10), h // 2)
            x1 = rs.randint(0, w - bw)
            y1 = rs.randint(0, h - bh)
            mask = _render_shape(cls - 1, bh, bw)
            color = self.colors[cls] + rs.normal(0, 4, size=3).astype(np.float32)
            region = img[y1:y1 + bh, x1:x1 + bw]
            img[y1:y1 + bh, x1:x1 + bw] = np.where(
                mask[..., None] > 0.5, color[None, None, :] + region * 0.1, region
            )
            gt_boxes[i] = (x1, y1, x1 + bw - 1, y1 + bh - 1)
            gt_classes[i] = cls
            gt_valid[i] = True
            # store the gt mask resampled to (S, S) with nearest sampling
            ys = np.clip((np.arange(s) + 0.5) * bh / s, 0, bh - 1).astype(int)
            xs = np.clip((np.arange(s) + 0.5) * bw / s, 0, bw - 1).astype(int)
            gt_masks[i] = mask[np.ix_(ys, xs)]

        return {
            "image": img,
            "im_info": np.array([h, w, 1.0], np.float32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "gt_masks": gt_masks,
        }

    def full_masks(self, index: int) -> np.ndarray:
        """(G_valid, H, W) binary canvas-space gt masks for evaluation."""
        ex = self.example(index)
        h, w = self.canvas_hw
        out = []
        for i in range(self.max_gt):
            if not ex["gt_valid"][i]:
                continue
            x1, y1, x2, y2 = ex["gt_boxes"][i].astype(int)
            canvas = np.zeros((h, w), np.float32)
            canvas[y1:y2 + 1, x1:x2 + 1] = _render_shape(int(ex["gt_classes"][i]) - 1,
                                                         y2 - y1 + 1, x2 - x1 + 1)
            out.append(canvas)
        return np.stack(out) if out else np.zeros((0, h, w), np.float32)

    def batch(self, indices) -> dict:
        """Stack examples along a leading batch axis."""
        exs = [self.example(i) for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}
