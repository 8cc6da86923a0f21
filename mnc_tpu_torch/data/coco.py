"""COCO instance segmentation — port of ``mnc_tpu/data/coco.py``.

MNC with the ResNet-101 trunk won the COCO 2015 segmentation challenge; this
reader gives the port the COCO side of that configuration without
pycocotools: plain JSON parsing, compressed-RLE decoding and encoding
(compatible with pycocotools' string format), and polygon rasterization by
``cv2.fillPoly``.  cv2 is imported by ``polygons_to_mask`` only: a dataset
whose segmentations are all RLE reads without it (the machine with the GPU
has no cv2), and a polygon there raises an error that names the annotation.

Expected layout::

    <root>/annotations/instances_<split>.json
    <root>/images/<split>/<file_name>

with ``<root>`` = ``cfg.DATA_DIR/coco`` by default.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.data.imdb import IMDB


def decode_coco_rle(counts, h: int, w: int) -> np.ndarray:
    """COCO RLE counts (a list of ints or a compressed string) → (h, w)
    uint8 mask (runs are column-major)."""
    if isinstance(counts, str):
        counts = _decode_rle_string(counts)
    counts = np.asarray(counts, np.int64)
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for run in counts:
        flat[pos:pos + run] = v
        pos += run
        v = 1 - v
    return flat.reshape(w, h).T  # column-major


def _decode_rle_string(s: str) -> list[int]:
    """pycocotools' compressed RLE string → run lengths (signed LEB-5,
    each count from the 4th on a delta from the count two before)."""
    counts: list[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_rle_string(counts) -> str:
    """Run lengths → pycocotools' compressed RLE string (the inverse of
    :func:`_decode_rle_string`)."""
    out = []
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:  # pycocotools deltas from the 4th count on (rleToString)
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def encode_coco_rle(mask: np.ndarray) -> dict:
    """Binary (h, w) mask → COCO compressed-RLE segmentation
    ``{"counts": str, "size": [h, w]}`` (column-major runs, the first a
    possibly empty run of zeros)."""
    m = np.asarray(mask) > 0.5
    h, w = m.shape
    flat = m.T.reshape(-1)  # column-major, as pycocotools
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"counts": _encode_rle_string(counts), "size": [h, w]}


def polygons_to_mask(polys, h: int, w: int, what: str = "a polygon segmentation") -> np.ndarray:
    """COCO polygons (flat x, y lists) → (h, w) uint8 mask, rasterized by
    ``cv2.fillPoly`` on the rounded vertices.  ``what`` names the
    annotation in the error raised where cv2 does not import."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{what}: rasterizing COCO polygons needs cv2 (cv2.fillPoly), which does not "
            "import here; give the dataset RLE segmentations (data.coco.encode_coco_rle) "
            "instead") from None
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def annotation_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """One annotation's segmentation (polygons or RLE) → (h, w) uint8 mask."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w, f"COCO annotation {ann.get('id')!r} of image "
                                           f"{ann.get('image_id')!r}")
    return decode_coco_rle(seg["counts"], *seg["size"])


class COCOSeg(IMDB):
    """COCO instances in the maskdb convention (masks cropped to their boxes
    at a fixed resolution, nearest-sampled as in the JAX package).  Crowd
    annotations and those below ``min_area`` are left out.  The classes are
    the json's categories sorted by id, after ``__background__``."""

    def __init__(self, split: str = "val2017", root: str | None = None,
                 gt_mask_size: int = 112, cache_dir: str | None = None,
                 min_area: float = 16.0):
        self._root = root or osp.join(cfg.DATA_DIR, "coco")
        self._split = split
        self.gt_mask_size = gt_mask_size
        self.min_area = min_area
        self._cache_dir = cache_dir or osp.join(cfg.DATA_DIR, "cache")
        self._data = None
        self._index = None
        self._by_image = None
        self._ann_path = osp.join(self._root, "annotations", f"instances_{split}.json")
        # the classes come with the json, read on first use
        super().__init__(f"coco_{split}", ("__background__",))

    def _load(self):
        if self._data is not None:
            return
        with open(self._ann_path) as f:
            self._data = json.load(f)
        cats = sorted(self._data["categories"], key=lambda c: c["id"])
        self._classes = ("__background__",) + tuple(c["name"] for c in cats)
        self._cat_to_label = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self._images = {im["id"]: im for im in self._data["images"]}
        self._index = sorted(self._images)
        by_img: dict = {i: [] for i in self._index}
        for ann in self._data["annotations"]:
            if ann.get("iscrowd", 0) or ann.get("area", 0) < self.min_area:
                continue
            by_img.setdefault(ann["image_id"], []).append(ann)
        self._by_image = by_img

    @property
    def image_index(self):
        self._load()
        return self._index

    @property
    def classes(self):
        self._load()
        return self._classes

    @property
    def num_classes(self) -> int:
        return len(self.classes)  # read from the json, also before any record

    def image_path_at(self, i):
        self._load()
        im = self._images[self._index[i]]
        return osp.join(self._root, "images", self._split, im["file_name"])

    def _entry(self, image_id):
        im = self._images[image_id]
        h, w = im["height"], im["width"]
        anns = self._by_image.get(image_id, [])
        s = self.gt_mask_size
        boxes = np.zeros((len(anns), 4), np.float32)
        classes = np.zeros((len(anns),), np.int32)
        masks = np.zeros((len(anns), s, s), np.float32)
        for k, ann in enumerate(anns):
            x, y, bw, bh = ann["bbox"]
            boxes[k] = [x, y, x + max(bw - 1, 0), y + max(bh - 1, 0)]
            classes[k] = self._cat_to_label[ann["category_id"]]
            full = annotation_to_mask(ann, h, w)
            x1, y1, x2, y2 = boxes[k].astype(int)
            crop = full[y1:y2 + 1, x1:x2 + 1].astype(np.float32)
            if crop.size == 0:
                continue
            ys = np.clip(((np.arange(s) + 0.5) * crop.shape[0] / s).astype(int),
                         0, crop.shape[0] - 1)
            xs = np.clip(((np.arange(s) + 0.5) * crop.shape[1] / s).astype(int),
                         0, crop.shape[1] - 1)
            masks[k] = crop[np.ix_(ys, xs)]
        return {"index": image_id, "boxes": boxes, "classes": classes,
                "masks": masks, "flipped": False}

    def roidb(self):
        """Per image: index, boxes (G, 4), classes (G,), masks (G, S, S),
        flipped; cached as a pickle under ``cache_dir``."""
        self._load()
        cache = osp.join(self._cache_dir, f"{self.name}_roidb.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)  # a file this class wrote
        db = [self._entry(i) for i in self._index]
        os.makedirs(self._cache_dir, exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(db, f)
        return db

    def maskdb(self):
        return [{"masks": e["masks"]} for e in self.roidb()]

    def gt_instances(self):
        self._load()
        out = {}
        for image_id in self._index:
            im = self._images[image_id]
            h, w = im["height"], im["width"]
            out[image_id] = [
                {"class_id": self._cat_to_label[a["category_id"]],
                 "mask": annotation_to_mask(a, h, w)}
                for a in self._by_image.get(image_id, [])]
        return out
