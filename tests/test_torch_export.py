"""The kernels as custom ops and the ``torch.export`` artifact, on the CPU.

- ``torch.library.opcheck`` on the CPU implementation of each custom op
  (``mnc::roi_warp``, ``mnc::nms_keep``, ``mnc::paste_binarize``,
  ``mnc::block1``): schema (no aliasing, no mutation), fake shapes and
  dtypes against the real outputs, registration, and the op under
  AOTAutograd; and no output shares storage with an input, also where NMS
  suppresses nothing.
- ``export_inference`` of the single-image and the B = 2 programs of
  ``tests/test_torch_slice.py``'s small architecture (f32, plain versions):
  outputs bit-equal to the live ``MNCPipeline``; the saved artifact loaded
  and run in a fresh interpreter that imports no ``mnc_tpu_torch.models``
  module, bit-equal again; the meta carries ``binarize_thresh`` and is read
  without loading the program, so that ``ExportedPipeline`` refuses a
  batched artifact or another device before it loads anything;
  ``ExportedPipeline.detect`` equal to ``MNCPipeline.detect``, every key
  bit for bit.
"""

import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from mnc_tpu_torch.config import cfg
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.ops.block1 import block1_op
from mnc_tpu_torch.ops.masks import _paste_axis_weights, paste_binarize_op
from mnc_tpu_torch.ops.nms import nms_keep_op
from mnc_tpu_torch.ops.roi_warp import roi_warp_op
from mnc_tpu_torch.pipeline.export import (ExportedPipeline, deserialize_inference,
                                           export_inference, exported_meta, save_exported)
from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
             post_nms_top_n=16, rpn_min_size=4.0)
POST = dict(dets_per_class=4, max_per_image=8, binarize_thresh=0.35)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand(2, 40, 2, generator=g) * 80
    boxes = torch.cat([boxes, boxes + 5 + torch.rand(2, 40, 2, generator=g) * 30], -1)
    rois = boxes[:, :6].contiguous()
    wy = _paste_axis_weights(rois[0, :, 1], rois[0, :, 3], 7, 24)
    wxt = _paste_axis_weights(rois[0, :, 0], rois[0, :, 2], 7, 32).transpose(1, 2).contiguous()
    far = torch.arange(5, dtype=torch.float32)[None, :, None] * 100 + torch.tensor(
        [0.0, 0.0, 10.0, 10.0])  # no box overlaps another: NMS keeps every valid one
    return {
        "roi_warp f32": (roi_warp_op, (torch.randn(2, 6, 8, 8, generator=g), rois, 3, 4, 0.25)),
        "roi_warp bf16": (roi_warp_op, (torch.randn(2, 6, 8, 8, generator=g).to(torch.bfloat16),
                                        rois, 2, 2, 0.125)),
        "nms_keep": (nms_keep_op, (boxes.contiguous(), torch.rand(2, 40, generator=g) > 0.2,
                                   0.5, 0)),
        "nms_keep top_n": (nms_keep_op, (boxes.contiguous(), torch.ones(2, 40, dtype=torch.bool),
                                         0.3, 5)),
        "nms_keep nothing suppressed": (nms_keep_op, (far.contiguous(),
                                                      torch.ones(1, 5, dtype=torch.bool), 0.5, 0)),
        "paste_binarize": (paste_binarize_op, (wy, torch.rand(6, 7, 7, generator=g), wxt, 0.4)),
        "block1": (block1_op, (torch.randn(2, 8, 6, 3, generator=g) * 50,
                               torch.randn(64, 3, 3, 3, generator=g) * 0.1,
                               torch.randn(64, generator=g),
                               torch.randn(64, 64, 3, 3, generator=g) * 0.05,
                               torch.randn(64, generator=g))),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_custom_op_passes_opcheck_and_returns_a_fresh_tensor(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    ptrs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
    assert out.untyped_storage().data_ptr() not in ptrs


@pytest.fixture(scope="module")
def small():
    model = MNC(MNCArch(compute_dtype=torch.float32, **SMALL), device="cpu")
    post = PostCfg(**POST)
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, size=(2, 96, 128, 3)).astype(np.uint8)
    infos = np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], np.float32)
    blobs = {b: export_inference(model, post, batch=b) for b in (None, 2)}
    return model, post, imgs, infos, blobs


def _zip_without_meta() -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("archive/extra/other.json", "{}")
    return buf.getvalue()


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_batched_artifact_is_bit_equal_to_the_pipeline(small):
    model, post, imgs, infos, blobs = small
    want = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    assert want["valid"].any()
    got = deserialize_inference(blobs[2])(torch.from_numpy(imgs), torch.from_numpy(infos))
    _assert_equal(got, want)


def test_single_image_artifact_is_bit_equal_to_the_pipeline(small):
    model, post, imgs, infos, blobs = small
    fn = deserialize_inference(blobs[None])
    for im, info in zip(imgs, infos):
        want = MNCPipeline(model, post).detect_canvas(im, info)
        _assert_equal(fn(torch.from_numpy(im), torch.from_numpy(info)), want)


def test_meta_carries_the_host_knobs(small):
    _, _, _, _, blobs = small
    assert exported_meta(blobs[2]) == {"binarize_thresh": 0.35, "paste": True,
                                       "canvas": [96, 128], "batch": 2, "u8": True,
                                       "device": "cpu"}
    assert exported_meta(blobs[None])["batch"] is None
    assert ExportedPipeline(blobs[None], binarize_thresh=0.5).binarize_thresh == 0.5
    with pytest.raises(ValueError, match="single-image"):
        ExportedPipeline(blobs[2])
    with pytest.raises(ValueError, match="exported on cpu"):
        ExportedPipeline(blobs[None], device="cuda")
    with pytest.raises(ValueError, match="not an artifact"):
        exported_meta(_zip_without_meta())


def test_saved_artifact_runs_in_a_fresh_interpreter_without_model_code(small, tmp_path):
    model, post, imgs, infos, blobs = small
    path, inputs, outputs = (str(tmp_path / n) for n in ("b2.pt2", "in.pt", "out.pt"))
    save_exported(path, blobs[2])
    torch.save({"imgs": torch.from_numpy(imgs), "infos": torch.from_numpy(infos)}, inputs)
    # the same intra-op thread count as this process: torch's CPU convolutions
    # sum in an order that depends on it, and the outputs are held bit for bit
    code = ("import sys, torch\n"
            f"torch.set_num_threads({torch.get_num_threads()})\n"
            "from mnc_tpu_torch.pipeline.export import load_exported\n"
            "fn = load_exported(sys.argv[1])\n"
            "inp = torch.load(sys.argv[2])\n"
            "torch.save(fn(inp['imgs'], inp['infos']), sys.argv[3])\n"
            "print(sorted(m for m in sys.modules if m.startswith(('mnc_tpu_torch.models', "
            "'jax', 'mnc_tpu.'))))\n")
    res = subprocess.run([sys.executable, "-c", code, path, inputs, outputs], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
    want = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    _assert_equal(torch.load(outputs), want)


def test_exported_pipeline_detect_equals_the_pipeline(small):
    model, post, _, _, blobs = small
    rs = np.random.RandomState(3)
    saved = cfg.clone()
    try:
        cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (96,), 128
        exported, live = ExportedPipeline(blobs[None]), MNCPipeline(model, post)
        for h, w in ((70, 110), (96, 128), (150, 260)):
            im = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            got, want = exported.detect(im), live.detect(im)
            assert exported.binarize_thresh == 0.35  # from the meta
            assert set(got) == set(want) and want["valid"].any()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        cfg.clear()
        cfg.update(saved)


def test_fused_block1_model_exports_with_block1_as_one_node():
    """``NET.FUSED_BLOCK1``: block 1 is the ``mnc::block1`` node (no packing
    cache in the graph) and the artifact stays bit-equal, here in bf16."""
    arch = MNCArch(compute_dtype=torch.bfloat16, fused_block1=True,
                   **dict(SMALL, canvas=(48, 64), n_stages=3, pre_nms_top_n=32,
                          post_nms_top_n=8))
    model = MNC(arch, device="cpu")
    post = PostCfg(**POST)
    blob = export_inference(model, post, batch=1)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("mnc.block1.default") == 1
    assert targets.count("mnc.roi_warp.default") == 1 and "mnc.nms_keep.default" in targets
    imgs = np.random.RandomState(5).randint(0, 256, size=(1, 48, 64, 3)).astype(np.uint8)
    infos = np.array([[48.0, 64.0, 1.0]], np.float32)
    want = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    with torch.inference_mode():
        got = program.module()(torch.from_numpy(imgs), torch.from_numpy(infos))
    _assert_equal(got, want)
