"""The synthetic shapes dataset in the IMDB interface — port of
``mnc_tpu/data/synth_imdb.py`` (same images, same ground truth)."""

from __future__ import annotations

import numpy as np

from mnc_tpu_torch.data.imdb import IMDB
from mnc_tpu_torch.data.synthetic import SHAPE_NAMES, SyntheticShapes


class SyntheticIMDB(IMDB):
    def __init__(self, canvas_hw=(128, 160), num_classes=6, max_gt=8,
                 gt_mask_size=28, num_images=64, seed=0, n_range=None):
        names = ("__background__",) + SHAPE_NAMES[: num_classes - 1]
        super().__init__(f"synthetic_{num_images}", names)
        gen_kw = {} if n_range is None else {"n_range": tuple(n_range)}
        self.gen = SyntheticShapes(canvas_hw, num_classes, max_gt, gt_mask_size,
                                   seed=seed, num_images=num_images, **gen_kw)
        self.gt_mask_size = gt_mask_size

    @property
    def image_index(self):
        return list(range(self.gen.num_images))

    def image_path_at(self, i):
        return f"synthetic://{i}"

    def example(self, i: int) -> dict:
        return self.gen.example(i)

    def roidb(self):
        db = []
        for i in self.image_index:
            ex = self.gen.example(i)
            n = int(ex["gt_valid"].sum())
            db.append({"index": i, "boxes": ex["gt_boxes"][:n],
                       "classes": ex["gt_classes"][:n], "flipped": False})
        return db

    def maskdb(self):
        out = []
        for i in self.image_index:
            ex = self.gen.example(i)
            out.append({"masks": ex["gt_masks"][: int(ex["gt_valid"].sum())]})
        return out

    def gt_instances(self):
        out = {}
        for i in self.image_index:
            ex = self.gen.example(i)
            full = self.gen.full_masks(i)
            out[i] = [{"class_id": int(c), "mask": m.astype(np.uint8)}
                      for c, m in zip(ex["gt_classes"][ex["gt_valid"]], full)]
        return out
