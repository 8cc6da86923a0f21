"""PASCAL VOC detection and SBD instance segmentation — port of
``mnc_tpu/data/pascal_voc.py`` (≙ the reference ``lib/datasets/
pascal_voc_det.py`` / ``pascal_voc_seg.py`` / ``lib/db/maskdb.py``).

VOC XML boxes; SBD (benchmark_RELEASE) ``inst/*.mat`` + ``cls/*.mat``
instance maps read with ``scipy.io.loadmat``; the maskdb (each instance
cropped to its box and resized to ``gt_mask_size`` by cv2's INTER_AREA
arithmetic, ``utils.blob.resize_mask_area``) cached as a pickle; and
``get_imdb``, the name → imdb factory.

Expected layout (the reference's ``data/`` conventions)::

    <DATA_DIR>/VOCdevkit<year>/VOC<year>/{JPEGImages,Annotations,ImageSets}
    <DATA_DIR>/sbd/benchmark_RELEASE/dataset/{inst,cls,img}/
    <DATA_DIR>/sbd/{train,val}.txt                (image id lists)

Images are named ``<id>.jpg``; ``data.loader.load_image`` reads them by
their content (PNG without cv2, anything else with it).  All disk access is
lazy.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.data.imdb import IMDB
from mnc_tpu_torch.utils.blob import resize_mask_area

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVOCDet(IMDB):
    """VOC detection annotations (XML): boxes only, "difficult" objects
    left out, 1-based pixel indices made 0-based."""

    def __init__(self, image_set: str, year: str = "2012", devkit_path: str | None = None):
        super().__init__(f"voc_{year}_{image_set}", VOC_CLASSES)
        self._image_set = image_set
        self._year = year
        self._devkit = devkit_path or osp.join(cfg.DATA_DIR, f"VOCdevkit{year}")
        self._data_path = osp.join(self._devkit, f"VOC{year}")
        self._index = None

    @property
    def image_index(self):
        if self._index is None:
            path = osp.join(self._data_path, "ImageSets", "Main", f"{self._image_set}.txt")
            with open(path) as f:
                self._index = [x.strip() for x in f if x.strip()]
        return self._index

    def image_path_at(self, i):
        return osp.join(self._data_path, "JPEGImages", f"{self.image_index[i]}.jpg")

    def _load_annotation(self, index: str) -> dict:
        tree = ET.parse(osp.join(self._data_path, "Annotations", f"{index}.xml"))
        objs = [o for o in tree.findall("object") if int(o.find("difficult").text) == 0]
        boxes = np.zeros((len(objs), 4), np.float32)
        classes = np.zeros((len(objs),), np.int32)
        for i, obj in enumerate(objs):
            bb = obj.find("bndbox")
            boxes[i] = [float(bb.find(t).text) - 1 for t in ("xmin", "ymin", "xmax", "ymax")]
            classes[i] = self.classes.index(obj.find("name").text.lower().strip())
        return {"boxes": boxes, "classes": classes, "flipped": False, "index": index}

    def roidb(self):
        return [self._load_annotation(ix) for ix in self.image_index]


class PascalVOCSeg(IMDB):
    """SBD instance segmentation, the reference's training and evaluation
    set: instances from ``inst/<id>.mat`` (instance id map) and
    ``cls/<id>.mat`` (class id map), each instance's class the most common
    class id under it; the maskdb is cached under ``cache_dir``."""

    def __init__(self, image_set: str, devkit_path: str | None = None,
                 gt_mask_size: int = 112, cache_dir: str | None = None):
        super().__init__(f"voc_2012_seg_{image_set}", VOC_CLASSES)
        self._image_set = image_set
        self._root = devkit_path or osp.join(cfg.DATA_DIR, "sbd")
        self._dataset = osp.join(self._root, "benchmark_RELEASE", "dataset")
        self.gt_mask_size = gt_mask_size
        self._cache_dir = cache_dir or osp.join(cfg.DATA_DIR, "cache")
        self._index = None
        self._records = None

    @property
    def image_index(self):
        if self._index is None:
            for cand in (osp.join(self._root, f"{self._image_set}.txt"),
                         osp.join(self._dataset, f"{self._image_set}.txt")):
                if osp.exists(cand):
                    with open(cand) as f:
                        self._index = [x.strip() for x in f if x.strip()]
                    break
            else:
                raise FileNotFoundError(
                    f"SBD split list {self._image_set}.txt not found under {self._root}")
        return self._index

    def image_path_at(self, i):
        return osp.join(self._dataset, "img", f"{self.image_index[i]}.jpg")

    def _load_mats(self, index: str):
        from scipy.io import loadmat

        inst = loadmat(osp.join(self._dataset, "inst", f"{index}.mat"))
        clsm = loadmat(osp.join(self._dataset, "cls", f"{index}.mat"))
        inst_map = inst["GTinst"]["Segmentation"][0][0]
        cls_map = clsm["GTcls"]["Segmentation"][0][0]
        return inst_map.astype(np.int32), cls_map.astype(np.int32)

    def _instances(self, index: str):
        """One image's instances: a list of (class id, full bool mask,
        tight (x1, y1, x2, y2) box)."""
        inst_map, cls_map = self._load_mats(index)
        out = []
        for iid in np.unique(inst_map):
            if iid <= 0:  # 0 background; 255 / -1 void
                continue
            m = inst_map == iid
            if not m.any():
                continue
            cls_ids, counts = np.unique(cls_map[m], return_counts=True)
            cls = int(cls_ids[np.argmax(counts)])
            if cls <= 0 or cls >= self.num_classes:
                continue
            ys, xs = np.where(m)
            out.append((cls, m, np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                                         np.float32)))
        return out

    def _build_records(self):
        os.makedirs(self._cache_dir, exist_ok=True)
        cache = osp.join(self._cache_dir, f"{self.name}_s{self.gt_mask_size}_maskdb.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)  # a file this class wrote
        s = self.gt_mask_size
        records = []
        for index in self.image_index:
            inst = self._instances(index)
            boxes = np.zeros((len(inst), 4), np.float32)
            classes = np.zeros((len(inst),), np.int32)
            masks = np.zeros((len(inst), s, s), np.float32)
            for i, (cls, m, box) in enumerate(inst):
                boxes[i] = box
                classes[i] = cls
                x1, y1, x2, y2 = box.astype(int)
                # area-filtered: soft values survive until intersect_mask
                # binarizes the final target
                masks[i] = resize_mask_area(m[y1:y2 + 1, x1:x2 + 1].astype(np.float32), (s, s))
            records.append({"index": index, "boxes": boxes, "classes": classes,
                            "masks": masks, "flipped": False})
        with open(cache, "wb") as f:
            pickle.dump(records, f)
        return records

    @property
    def records(self):
        if self._records is None:
            self._records = self._build_records()
        return self._records

    def roidb(self):
        return [{k: r[k] for k in ("index", "boxes", "classes", "flipped")}
                for r in self.records]

    def maskdb(self):
        return [{"masks": r["masks"]} for r in self.records]

    def gt_instances(self):
        return {index: [{"class_id": cls, "mask": m.astype(np.uint8)}
                        for cls, m, _ in self._instances(index)]
                for index in self.image_index}


_FACTORY: dict = {}


def get_imdb(name: str) -> IMDB:
    """Name → imdb (≙ the reference's ``lib/datasets`` factory): a name
    given to :func:`register_imdb`, ``voc_2012_seg_<set>`` (SBD),
    ``voc_<year>_<set>`` (VOC detection), ``synthetic[_<n>]`` (n images, 64
    by default) or ``coco_<split>``."""
    if name in _FACTORY:
        return _FACTORY[name]()
    if name.startswith("voc_2012_seg_"):
        return PascalVOCSeg(name.split("voc_2012_seg_")[1])
    if name.startswith("voc_"):
        _, year, image_set = name.split("_", 2)
        return PascalVOCDet(image_set, year)
    if name.startswith("synthetic"):
        from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

        n = int(name.split("_")[1]) if "_" in name else 64
        return SyntheticIMDB(num_images=n)
    if name.startswith("coco_"):
        from mnc_tpu_torch.data.coco import COCOSeg

        return COCOSeg(name.split("coco_", 1)[1])
    raise KeyError(f"unknown imdb {name!r}")


def register_imdb(name: str, ctor) -> None:
    """Make ``get_imdb(name)`` return ``ctor()``."""
    _FACTORY[name] = ctor
