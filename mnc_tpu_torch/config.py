"""Global configuration tree (the PyTorch port's own copy).

Every key of ``mnc_tpu.config`` is kept, so ``experiments/cfgs/*.yml`` load
unchanged; ``yaml`` is imported inside the functions that parse YAML, so the
package imports on machines without it.

Behavioral port of the reference config system (``lib/mnc_config.py`` in
daijifeng001/MNC): a singleton ``cfg`` tree with ``TRAIN``/``TEST`` sub-trees,
recursive YAML merge (``cfg_from_file``), ``--set KEY VALUE`` overrides
(``cfg_from_list``) and ``get_output_dir``.  The reference key names
(``TRAIN.RPN_NMS_THRESH`` etc.) are preserved so its experiment YAMLs translate
1:1.

``cfg.STATIC`` holds the fixed shapes (canvas, proposal counts, RoI batch) that
the reference computed per image on the host; the port keeps the JAX
package's padded shapes and validity masks, so its outputs compare element by
element.  Keys that select between XLA/Pallas formulations of the JAX package
(``NET.ROI_WARP_IMPL``, ``TEST.PASTE_IMPL``, ``TEST.PASTE_DTYPE``,
``TEST.VOTE_IMPL``, ``STATIC.NMS_CHUNK``'s tile size) are read but the port has
one route for each op: its CUDA kernel on the GPU, its plain version on the
CPU.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
from typing import Any

import numpy as np


class AttrDict(dict):
    """Dict with attribute access — stand-in for the reference's easydict."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "AttrDict":
        return copy.deepcopy(self)


def _tree(**kw: Any) -> AttrDict:
    d = AttrDict()
    for k, v in kw.items():
        d[k] = v
    return d


# --------------------------------------------------------------------------- #
# Defaults.  Values follow the reference defaults (lib/mnc_config.py) where
# known; ⚠-uncertain ones from SURVEY.md §2.1 are noted inline.
# --------------------------------------------------------------------------- #

__C = _tree()
cfg = __C

# ---- global ----
__C.RNG_SEED = 3
__C.EPS = 1e-14
__C.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])  # BGR order
__C.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), ".."))
__C.DATA_DIR = osp.join(__C.ROOT_DIR, "data")
__C.EXP_DIR = "default"
__C.USE_GPU_NMS = True  # kept for YAML compat; NMS always runs on the device
__C.GPU_ID = 0  # YAML compat; the port's entry points take a device argument
# Mask resolution of the mask regression target/output (the reference code
# used 21; the paper quotes 28).
__C.MASK_SIZE = 21
# Binarization threshold applied when pasting soft masks back into the image.
__C.BINARIZE_THRESH = 0.4

# ---- static shapes (no reference equivalent): padded sizes + validity masks ----
__C.STATIC = _tree()
# Fixed image canvas (H, W).  Images are aspect-preserving resized with the
# reference rule (shorter side -> SCALES[0], longer side capped at MAX_SIZE)
# and additionally capped to fit this canvas, then zero-padded to it.  Must be
# divisible by FEAT_STRIDE.  (640, 1024) covers landscape VOC at the reference
# scale; portrait images get slightly more downscale than the reference.
__C.STATIC.CANVAS = (640, 1024)
# Anchors are laid over the stride-16 feature grid of the canvas.
__C.STATIC.FEAT_STRIDE = 16
# Static #proposals kept after top-k pre-NMS / after NMS (train, test).
# Reference: 12000/2000 train, 6000/300 test; both default to the full
# reference working sets.
__C.STATIC.TRAIN_PRE_NMS_TOP_N = 12000
__C.STATIC.TRAIN_POST_NMS_TOP_N = 2000
__C.STATIC.TEST_PRE_NMS_TOP_N = 6000
__C.STATIC.TEST_POST_NMS_TOP_N = 304  # padded 300 (a multiple of 8)
# Proposal-NMS working sets larger than this stop the greedy scan at the
# post-NMS count (ops/nms.py::nms_tiled).  0 = auto: 512 train, 256 test.
__C.STATIC.NMS_CHUNK = 0
# Max ground-truth instances per image (padded).
__C.STATIC.MAX_GT = 32

# ---- network ----
__C.NET = _tree()
__C.NET.TRUNK = "vgg16"  # or "resnet101"
__C.NET.NUM_CLASSES = 21  # VOC: 20 + background
__C.NET.ANCHOR_SCALES = (8, 16, 32)
__C.NET.ANCHOR_RATIOS = (0.5, 1.0, 2.0)
__C.NET.WARP_HW = 14  # RoI-warp output resolution (roi_warping_layer pooled_h/w)
# fc6 input resolution after the classify head's max pool; None → WARP_HW // 2
# (= the reference's 7 at WARP_HW 14).  Must divide WARP_HW when set.
__C.NET.POOLED_HW = None
__C.NET.FC_DIM = 4096
__C.NET.MASK_FC_DIM = 256
__C.NET.N_STAGES = 5  # 3 or 5
# Compute dtype for conv trunk / heads.
__C.NET.COMPUTE_DTYPE = "bfloat16"
# Dual-pathway classification head (mask-pooled + box features concatenated).
__C.NET.DUAL_PATHWAY = False
# ResNet trunks: run conv5 per-RoI after warping (the reference COCO head)
# instead of the fc6/fc7 tower.
__C.NET.ROI_CONV5 = False
# ResNet bottleneck stride placement: False = v1 (stride on the first 1x1,
# the original MSRA/Caffe geometry — reference parity); True = v1.5 (stride
# on the 3x3) — REQUIRED for torchvision-pretrained resnet50/101/152 weights
# (they were trained v1.5; a v1 import matches every shape but computes
# features the weights were never trained for).  train_net auto-enables this
# when importing a torchvision .pth into a from-scratch model.
__C.NET.RESNET_STRIDE_IN_3X3 = False
# Zero proposals from anchor types with no trainable (fully-inside) position
# on the canvas.  Set False when running imported/foreign weights — the
# reference ProposalLayer scores all anchors (DESIGN.md §8).
__C.NET.SUPPRESS_UNTRAINABLE_ANCHORS = True
# RoI-warp realization in the JAX package; the port always uses its kernel.
__C.NET.ROI_WARP_IMPL = "einsum"
# VGG block-1 layouts of the JAX package (identical math; the port runs
# the plain convolution path either way).
__C.NET.S2D_BLOCK1 = False
__C.NET.FUSED_BLOCK1 = False
# Trunk blocks (VGG) / stages (ResNet) with stopped gradients.  The
# reference froze conv1-conv2 via lr_mult 0 (ImageNet-pretrained trunk,
# train_val.prototxt†); set 0 when training FROM SCRATCH — frozen random
# filters never learn (tools/e2e_synth_demo.py does this explicitly).
__C.NET.TRUNK_FROZEN = 2

# ---- training ----
__C.TRAIN = _tree()
__C.TRAIN.SCALES = (600,)
__C.TRAIN.MAX_SIZE = 1000
__C.TRAIN.IMS_PER_BATCH = 1
__C.TRAIN.BATCH_SIZE = 128  # RoIs per image  ⚠ reference may use 64
__C.TRAIN.FG_FRACTION = 0.25
__C.TRAIN.FG_THRESH = 0.5
__C.TRAIN.BG_THRESH_HI = 0.5
__C.TRAIN.BG_THRESH_LO = 0.0
# CFM training only: label segment proposals by "box" IoU (default) or
# "mask" IoU (segment mask vs gt instance mask, in image pixels).
__C.TRAIN.CFM_IOU = "box"
__C.TRAIN.USE_FLIPPED = True
# Real-image loader uploads uint8 canvases; the train step mean-subtracts
# on the device (device_normalize).
__C.TRAIN.U8_TRANSFER = True
__C.TRAIN.BBOX_REG = True
__C.TRAIN.BBOX_THRESH = 0.5
__C.TRAIN.BBOX_NORMALIZE_TARGETS = True
__C.TRAIN.BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
__C.TRAIN.BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)
__C.TRAIN.BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
__C.TRAIN.RPN_POSITIVE_OVERLAP = 0.7
__C.TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
__C.TRAIN.RPN_CLOBBER_POSITIVES = False
__C.TRAIN.RPN_FG_FRACTION = 0.5
__C.TRAIN.RPN_BATCHSIZE = 256
__C.TRAIN.RPN_NMS_THRESH = 0.7
__C.TRAIN.RPN_PRE_NMS_TOP_N = 12000   # reference value; STATIC caps what runs
__C.TRAIN.RPN_POST_NMS_TOP_N = 2000   # reference value; STATIC caps what runs
__C.TRAIN.RPN_MIN_SIZE = 16
__C.TRAIN.RPN_BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
__C.TRAIN.RPN_POSITIVE_WEIGHT = -1.0
__C.TRAIN.SNAPSHOT_ITERS = 5000
__C.TRAIN.SNAPSHOT_PREFIX = "mnc"
__C.TRAIN.SNAPSHOT_INFIX = ""
# Solver (reference models/VGG16/mnc_5stage/solver.prototxt)
__C.TRAIN.LEARNING_RATE = 0.001
__C.TRAIN.MOMENTUM = 0.9
__C.TRAIN.WEIGHT_DECAY = 0.0005
__C.TRAIN.GAMMA = 0.1
__C.TRAIN.STEPSIZE = 20000
__C.TRAIN.MAX_ITERS = 25000
__C.TRAIN.ITER_SIZE = 1  # gradient accumulation (solver iter_size)
# Caffe solver clip_gradients (global-norm clip); <= 0 disables.
__C.TRAIN.CLIP_GRADIENTS = -1.0
# The reference's TRAIN.MIX_INDEX roi-mixing flag is accepted-but-inert
# (COMPAT_ONLY_KEYS): stages 4-5 always train on the bridge-refined RoIs —
# see PARITY.md.  Kept as a key so reference YAMLs that set it still merge.
__C.TRAIN.MIX_INDEX = True

# ---- testing ----
__C.TEST = _tree()
__C.TEST.SCALES = (600,)
__C.TEST.MAX_SIZE = 1000
__C.TEST.NMS = 0.3
__C.TEST.RPN_NMS_THRESH = 0.7
__C.TEST.RPN_PRE_NMS_TOP_N = 6000   # reference value; STATIC caps what runs
__C.TEST.RPN_POST_NMS_TOP_N = 300   # reference value; STATIC caps what runs
__C.TEST.RPN_MIN_SIZE = 16
__C.TEST.BBOX_REG = True
# Mask voting (the reference TesterWrapper default).
__C.TEST.USE_MASK_MERGE = True
__C.TEST.USE_GPU_MASK_MERGE = True  # compat; mask voting always runs on the device
__C.TEST.MASK_MERGE_IOU_THRESH = 0.5
__C.TEST.MASK_MERGE_NMS_THRESH = 0.3
# Score-weighted BOX averaging over the same IoU>=MASK_MERGE_IOU_THRESH
# neighbor set the mask vote uses (the box half of the reference
# lib/nms/mv.pyx).  Default off = mask-only voting.
__C.TEST.VOTE_BOXES = False
# 5-stage only: pool the FIRST-pass (stage-3) detections into the NMS/voting
# candidate set alongside the refined second-pass ones (each with its own
# pass scores).  Default off = reference-shaped candidate set.
__C.TEST.VOTE_BOTH_PASSES = False
__C.TEST.CONF_THRESH = 0.7  # demo visualization threshold
# Run portrait images on the transposed canvas (exact reference scale rule)
# instead of extra-downscaling them into the landscape canvas.
__C.TEST.AUTO_PORTRAIT = True
# Bit-pack canvas masks on device for the detect() host transfer (identical
# outputs after host unpack; 8x less device->host traffic).
__C.TEST.PACKED_TRANSFER = True
# Skip the on-device canvas paste in detect()/detect_many() and unmold soft
# masks on the host per valid detection (the reference's own unmold path).
__C.TEST.HOST_PASTE = False
# Upload uint8 canvases from detect()/detect_many() and mean-subtract on
# the device; the only deviation from the float path is <=0.5-LSB uint8
# rounding after resize.  Off = reference-exact float canvases.
__C.TEST.U8_TRANSFER = True
# Optional smaller canvas sizes for detect(): each image runs on the smallest
# bucket that admits its full reference scale (trunk compute ~ area).  Every
# entry compiles one extra program variant.  Empty = single canvas.
# Example: ((480, 640), (512, 864))
__C.TEST.CANVAS_BUCKETS = ()
__C.TEST.MAX_PER_IMAGE = 100
# Voting mask-resample implementation of the JAX package; the port always
# runs the per-pair hat products ("einsum").
__C.TEST.VOTE_IMPL = "einsum"
# Canvas paste-back implementation and dtype of the JAX package; the port
# always pastes and binarizes in f32 (its kernel on the GPU).
__C.TEST.PASTE_IMPL = "auto"
__C.TEST.PASTE_DTYPE = "bf16"
# int8 inference of the JAX package (ops/quant.py); not ported yet, so the
# port refuses a config that sets it.
__C.TEST.INT8 = False

# Reference-YAML keys accepted for 1:1 config translation but with no
# behavior (documented inert):
#   GPU_ID                 device selection is the entry points' argument
#   TRAIN.BBOX_THRESH      roidb bbox-target precompute threshold (the
#                          Fast-RCNN-style path; targets here are on-device,
#                          FG_THRESH governs)
#   TEST.USE_GPU_MASK_MERGE voting is always on-device
#   TRAIN.MIX_INDEX        roi mixing; stages 4-5 always use bridged RoIs
COMPAT_ONLY_KEYS = {"GPU_ID", "TRAIN.BBOX_THRESH", "TEST.USE_GPU_MASK_MERGE",
                    "TRAIN.MIX_INDEX"}


# --------------------------------------------------------------------------- #
# YAML merge machinery (behavioral port of cfg_from_file / cfg_from_list).
# --------------------------------------------------------------------------- #


def _merge_a_into_b(a: dict, b: AttrDict, path: str = "") -> None:
    if not isinstance(a, dict):
        raise TypeError(f"config merge source at {path or '<root>'} must be a dict")
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = b[k]
        if isinstance(old, AttrDict):
            _merge_a_into_b(v, old, path=f"{path}{k}.")
            continue
        b[k] = _coerce(v, old, f"{path}{k}")


def _coerce(v: Any, old: Any, key: str) -> Any:
    if old is None or v is None:
        return v
    if isinstance(old, np.ndarray):
        return np.array(v, dtype=old.dtype)
    if isinstance(old, tuple):
        if isinstance(v, str):
            # YAML doesn't parse "(640, 1024)" — literal-eval it rather than
            # silently producing a tuple of characters
            import ast

            try:
                v = ast.literal_eval(v)
            except (SyntaxError, ValueError) as e:
                raise ValueError(
                    f"cannot parse {v!r} as a sequence for {key}") from e
        if not isinstance(v, (list, tuple)):
            raise ValueError(f"cannot coerce {v!r} to tuple for {key}")
        return tuple(v)
    if isinstance(old, bool):
        if isinstance(v, (bool, int)):
            return bool(v)
        raise ValueError(f"cannot coerce {v!r} to bool for {key}")
    if isinstance(old, float) and isinstance(v, (int, float)):
        return float(v)
    if isinstance(old, int) and isinstance(v, int):
        return v
    if type(old) is type(v):
        return v
    raise ValueError(f"type mismatch for {key}: {type(old).__name__} vs {type(v).__name__}")


def cfg_from_file(filename: str) -> None:
    """Load a YAML config file and merge it into the global cfg."""
    import yaml

    with open(filename) as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg:
        _merge_a_into_b(yaml_cfg, __C)


def cfg_from_list(cfg_list: list) -> None:
    """Set config keys from a flat ['KEY', value, ...] list (--set flag)."""
    import yaml

    assert len(cfg_list) % 2 == 0, "--set takes KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        keys = full_key.split(".")
        d = __C
        for k in keys[:-1]:
            d = d[k]
        if isinstance(v, str):
            try:
                v = yaml.safe_load(v)
            except yaml.YAMLError:
                pass
        d[keys[-1]] = _coerce(v, d[keys[-1]], full_key)


def get_output_dir(imdb_name: str, net_name: str | None = None) -> str:
    """Output directory: <ROOT>/output/<EXP_DIR>/<imdb>[/<net>]."""
    path = osp.join(__C.ROOT_DIR, "output", __C.EXP_DIR, imdb_name)
    if net_name is not None:
        path = osp.join(path, net_name)
    os.makedirs(path, exist_ok=True)
    return path


# ---- derived helpers ----


def canvas_hw() -> tuple[int, int]:
    h, w = __C.STATIC.CANVAS
    s = __C.STATIC.FEAT_STRIDE
    assert h % s == 0 and w % s == 0, "CANVAS must be divisible by FEAT_STRIDE"
    return int(h), int(w)


def feat_hw() -> tuple[int, int]:
    h, w = canvas_hw()
    s = __C.STATIC.FEAT_STRIDE
    return h // s, w // s


def num_anchors() -> int:
    return len(__C.NET.ANCHOR_SCALES) * len(__C.NET.ANCHOR_RATIOS)
