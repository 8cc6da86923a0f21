"""Dataset base class — port of ``mnc_tpu/data/imdb.py`` (≙ reference
``lib/db/imdb.py``), and ``get_imdb``, the name → imdb factory of
``mnc_tpu/data/pascal_voc.py`` (kept in ``data/pascal_voc.py``).

An imdb owns: a name, an ordered image index, per-image annotation records
(the *roidb*: gt boxes / classes), per-image instance masks (the *maskdb*),
and an evaluation hook.  Horizontal-flip augmentation mirrors boxes AND
masks (``append_flipped_images`` in the reference).
"""

from __future__ import annotations


class IMDB:
    def __init__(self, name: str, classes: tuple[str, ...]):
        self._name = name
        self._classes = classes

    # ---- identity ----
    @property
    def name(self) -> str:
        return self._name

    @property
    def classes(self) -> tuple[str, ...]:
        return self._classes

    @property
    def num_classes(self) -> int:
        return len(self._classes)

    # ---- to be provided by subclasses ----
    @property
    def image_index(self) -> list:
        raise NotImplementedError

    @property
    def num_images(self) -> int:
        return len(self.image_index)

    def image_path_at(self, i: int) -> str:
        raise NotImplementedError

    def roidb(self) -> list[dict]:
        """Per image: {boxes (G,4), classes (G,), flipped: bool}."""
        raise NotImplementedError

    def maskdb(self) -> list[dict]:
        """Per image: {masks (G, S, S) float in box frame} aligned with roidb."""
        raise NotImplementedError

    def gt_instances(self) -> dict:
        """Eval-side ground truth: {image_id: [{class_id, mask(full)}...]}."""
        raise NotImplementedError

    def evaluate(self, detections: list[dict], iou_threshs=(0.5, 0.7)) -> dict:
        """Thresholded mAP^r; the key "avg" in ``iou_threshs`` adds the
        COCO-style AP^r@[.5:.95] (eval_sds_averaged)."""
        from mnc_tpu_torch.data.eval_sds import eval_sds, eval_sds_averaged

        gt = self.gt_instances()
        out = {}
        for t in iou_threshs:
            if t == "avg":
                out[t] = eval_sds_averaged(detections, gt, self.num_classes)
            else:
                out[t] = eval_sds(detections, gt, self.num_classes, iou_thresh=t)
        return out

    # ---- augmentation ----
    @staticmethod
    def flip_entry(entry: dict, mask_entry: dict, width: int) -> tuple[dict, dict]:
        """Mirror one roidb/maskdb record horizontally (reference
        ``append_flipped_images`` semantics, masks included)."""
        boxes = entry["boxes"].copy()
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = width - boxes[:, 2] - 1
        boxes[:, 2] = width - x1 - 1
        out = dict(entry, boxes=boxes, flipped=True)
        masks = mask_entry["masks"][:, :, ::-1].copy()
        return out, dict(mask_entry, masks=masks)


def get_imdb(name: str) -> IMDB:
    """Name → imdb: ``data.pascal_voc.get_imdb``, which resolves
    ``voc_<year>_<set>``, ``voc_2012_seg_<set>``, ``coco_<split>``,
    ``synthetic[_<n>]`` and the names given to ``register_imdb``."""
    from mnc_tpu_torch.data.pascal_voc import get_imdb as factory

    return factory(name)
