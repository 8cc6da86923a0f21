"""Training data pipeline — port of ``mnc_tpu/data/loader.py`` (≙ the
reference ``lib/pylayer/mnc_data_layer.py`` + ``lib/db/roidb.py``).

Turns imdb roidb/maskdb records into the fixed-shape batches the train step
consumes: the image scaled by the reference rule and padded into the static
canvas, gt boxes scaled alike and padded to MAX_GT, gt masks at a fixed
resolution, and for CFM training each image's top-k segment proposals
(``tools/prepare_mcg_maskdb.py`` records).  Horizontal flips
(``TRAIN.USE_FLIPPED``) double the epoch.  A background thread prefetches
the batches.  Arrays are numpy, as in the JAX package; the train step's
caller moves them to the device.

Images come from the imdb: ``synthetic://`` paths from the imdb itself,
files through ``utils.png.imread``, which returns what ``cv2.imread`` does:
PNG content (whatever the file's name) is decoded without cv2, anything
else (JPEG) goes to cv2 and is an error where cv2 does not import, as on
the machine with the GPU.  Masks are resized with
``utils.blob.resize_mask_area``, cv2's INTER_AREA arithmetic in numpy.
"""

from __future__ import annotations

import os.path as osp
import pickle
import queue
import threading

import numpy as np

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.data.imdb import IMDB
from mnc_tpu_torch.utils import png
from mnc_tpu_torch.utils.blob import prep_im_for_blob, resize_mask_area


def load_image(imdb: IMDB, i: int) -> np.ndarray:
    path = imdb.image_path_at(i)
    if path.startswith("synthetic://"):
        return imdb.example(i)["image"]
    return png.imread(path)


def _resize_masks(masks: np.ndarray, size: int) -> np.ndarray:
    return np.stack([resize_mask_area(m, (size, size)) for m in masks])


def make_example(imdb: IMDB, roidb_entry: dict, mask_entry: dict, i: int, max_gt: int,
                 canvas_hw, gt_mask_size: int, train_scales=None, max_size=None,
                 synthetic: bool = False, u8: bool | None = None) -> dict:
    """One fixed-shape training example from db records.

    Synthetic imdbs give float canvases that are already mean-subtracted
    (padded with zeros, scale 1).  Real images are scaled and padded by
    ``prep_im_for_blob``; ``u8`` (default ``cfg.TRAIN.U8_TRANSFER``) keeps
    the canvas uint8, mean-subtracted on the device by the train step."""
    im = load_image(imdb, i)
    if roidb_entry.get("flipped"):
        im = im[:, ::-1]

    if synthetic:
        canvas = im.astype(np.float32)
        if canvas.shape[:2] != tuple(canvas_hw):
            padded = np.zeros((*canvas_hw, 3), np.float32)
            padded[: canvas.shape[0], : canvas.shape[1]] = canvas
            canvas = padded
        im_info = np.array([im.shape[0], im.shape[1], 1.0], np.float32)
        scale = 1.0
    else:
        if u8 is None:
            u8 = bool(cfg.TRAIN.U8_TRANSFER)
        canvas, im_info = prep_im_for_blob(
            im, target_size=(train_scales or cfg.TRAIN.SCALES)[0],
            max_size=max_size or cfg.TRAIN.MAX_SIZE, canvas_hw=canvas_hw, u8=u8)
        canvas = canvas.numpy()
        scale = float(im_info[2])

    g = min(len(roidb_entry["boxes"]), max_gt)
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_classes = np.zeros((max_gt,), np.int32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_masks = np.zeros((max_gt, gt_mask_size, gt_mask_size), np.float32)
    gt_boxes[:g] = roidb_entry["boxes"][:g] * scale
    gt_classes[:g] = roidb_entry["classes"][:g]
    gt_valid[:g] = True
    if g > 0:
        src = mask_entry["masks"][:g]
        gt_masks[:g] = src if src.shape[-1] == gt_mask_size else _resize_masks(src,
                                                                               gt_mask_size)
    return {"image": canvas, "im_info": im_info, "gt_boxes": gt_boxes,
            "gt_classes": gt_classes, "gt_valid": gt_valid, "gt_masks": gt_masks}


def load_segments(segdb_dir: str, image_id, top_k: int, mask_size: int):
    """The first ``top_k`` segment proposals of one image from its
    ``prepare_mcg_maskdb`` record, padded to ``top_k``: boxes (top_k, 4) in
    original-image coordinates, masks (top_k, S, S) resized to ``mask_size``
    (cv2's INTER_AREA), valid (top_k,), and the count of real ones."""
    path = osp.join(segdb_dir, f"{image_id}.pkl")
    if not osp.exists(path):
        raise FileNotFoundError(
            f"segdb: no segment proposals for image {image_id!r} ({path} missing): run "
            "mnc_tpu_torch.tools.prepare_mcg_maskdb over the full image list first")
    with open(path, "rb") as f:
        rec = pickle.load(f)  # a record prepare_mcg_maskdb wrote
    nseg = min(len(rec["boxes"]), top_k)
    boxes = np.zeros((top_k, 4), np.float32)
    masks = np.zeros((top_k, mask_size, mask_size), np.float32)
    valid = np.zeros((top_k,), bool)
    boxes[:nseg] = np.asarray(rec["boxes"][:nseg], np.float32)
    src = np.asarray(rec["masks"][:nseg], np.float32)
    if nseg:
        masks[:nseg] = src if src.shape[-1] == mask_size else _resize_masks(src, mask_size)
    valid[:nseg] = True
    return boxes, masks, valid, nseg


class TrainLoader:
    """Shuffled, flip-augmented, prefetching loader over an imdb.

    Iterates forever, yielding image-batched numpy dicts of shape
    (ims_per_batch, ...) (one example without the batch axis when
    ``ims_per_batch`` is 1).  The order is the JAX package's: an epoch is
    the (index, flipped) list shuffled by ``np.random.RandomState(seed)``
    and popped from its end.  With ``segdb_dir`` each example also carries
    ``seg_boxes`` (K, 4), ``seg_masks`` (K, S, S) and ``seg_valid`` (K,),
    the image's top K = ``seg_top_k`` segment proposals (CFM training).
    An exception in the prefetch thread is raised by the next ``next``.
    """

    def __init__(self, imdb: IMDB, max_gt=None, canvas_hw=None, gt_mask_size=28,
                 ims_per_batch=1, use_flipped=None, seed=3, prefetch=4, synthetic=None,
                 segdb_dir=None, seg_top_k=64, seg_mask_size=None):
        self.imdb = imdb
        self.roidb = imdb.roidb()
        self.maskdb = imdb.maskdb()
        self.segdb_dir = segdb_dir
        self.seg_top_k = seg_top_k
        self.seg_mask_size = seg_mask_size or int(cfg.MASK_SIZE)
        # the processed fixed-shape arrays per image, not the raw records: a
        # real MCG record holds thousands of full-size masks
        self._seg_cache: dict = {}
        self.max_gt = max_gt or cfg.STATIC.MAX_GT
        self.canvas_hw = canvas_hw or tuple(cfg.STATIC.CANVAS)
        self.gt_mask_size = gt_mask_size
        self.ims_per_batch = ims_per_batch
        self.use_flipped = cfg.TRAIN.USE_FLIPPED if use_flipped is None else use_flipped
        self.synthetic = imdb.name.startswith("synthetic") if synthetic is None else synthetic
        self.rs = np.random.RandomState(seed)
        self._perm: list = []
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _next_index(self):
        if not self._perm:
            n = len(self.roidb)
            entries = [(i, False) for i in range(n)]
            if self.use_flipped:
                entries += [(i, True) for i in range(n)]
            self.rs.shuffle(entries)
            self._perm = entries
        return self._perm.pop()

    def skip(self, n: int) -> None:
        """Advance the order by ``n`` examples without making them (a
        resumed run skips the steps it has taken); before the first
        ``next``."""
        if self._started:
            raise RuntimeError("TrainLoader.skip after the prefetch thread started")
        for _ in range(n):
            self._next_index()

    def _make(self, i: int, flipped: bool) -> dict:
        entry, masks = self.roidb[i], self.maskdb[i]
        width = None
        if flipped:
            # a synthetic image is the canvas; a real one's width is read once
            width = self.canvas_hw[1] if self.synthetic else entry.get("width")
            if width is None:
                width = entry["width"] = load_image(self.imdb, i).shape[1]
            entry, masks = IMDB.flip_entry(dict(entry, flipped=False), masks, width)
        ex = make_example(self.imdb, entry, masks, i, self.max_gt, self.canvas_hw,
                          self.gt_mask_size, synthetic=self.synthetic)
        if self.segdb_dir is not None:
            ex.update(self._segments(i, width, float(ex["im_info"][2])))
        return ex

    def _segments(self, i: int, flip_width, scale: float) -> dict:
        """The image's segment arrays, scaled to the canvas; a flipped copy
        mirrors the boxes about the original width (+1 convention, as
        ``IMDB.flip_entry``) and reverses the masks' x."""
        if i not in self._seg_cache:
            self._seg_cache[i] = load_segments(self.segdb_dir, self.imdb.image_index[i],
                                               self.seg_top_k, self.seg_mask_size)
        cboxes, cmasks, cvalid, nseg = self._seg_cache[i]
        boxes, masks, valid = cboxes.copy(), cmasks.copy(), cvalid.copy()
        if flip_width is not None:
            x1 = boxes[:nseg, 0].copy()
            boxes[:nseg, 0] = flip_width - boxes[:nseg, 2] - 1
            boxes[:nseg, 2] = flip_width - x1 - 1
            masks[:nseg] = masks[:nseg, :, ::-1]
        boxes[:nseg] *= scale
        return {"seg_boxes": boxes, "seg_masks": masks, "seg_valid": valid}

    def _batch(self) -> dict:
        exs = [self._make(*self._next_index()) for _ in range(self.ims_per_batch)]
        if self.ims_per_batch == 1:
            return exs[0]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._batch()
            except Exception as e:  # noqa: BLE001 — handed to the consumer
                self._put(e)
                return
            if not self._put(item):
                return

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if not self._started:
            self._thread.start()
            self._started = True
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop the prefetch thread (it ends within 0.1 s)."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
