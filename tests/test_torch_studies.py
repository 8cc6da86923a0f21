"""The port's study tools against the JAX package's, on the CPU:
``mnc_tpu_torch/tools/{crowd_study,workingset_study,mask_fidelity_study}.py``.

- ``crowd_study --smoke --params`` on the JAX smoke model's parameters
  (``MNC.init(PRNGKey(0))`` at the tool's tiny architecture, as the JAX tool
  draws them, saved by ``save_npz``) against ``tools/crowd_study.py
  --smoke`` as a subprocess, both with ``--eval-images 2 --dets-per-class
  16 --vote-top-k 64 0``: ``map_r_050``, ``map_r_070`` and
  ``max_dets_per_image_class`` equal in both records.
- ``workingset_study --smoke`` on the same parameters (one ``--pre-nms``,
  one ``--post-nms``: two points) against the same loop composed of the JAX
  package's functions (features → RPN → ``propose_rois`` →
  ``bbox_overlaps`` for the recall; ``MNCPipeline`` pasting in f32, as the
  port does; ``eval_sds``): recall and mAP^r equal.
- ``mask_fidelity_study --trials 12 --canvas 96 128 --mask-size 9`` against
  the JAX tool's ``main`` on the same arguments: the table's ``nearest``
  rows equal; the ``area`` rows within 0.02 (mean) and 0.1 (5th percentile
  and minimum), since ``resize_mask_area`` equals cv2's INTER_AREA only to
  f32 rounding and a stored value at the 0.5 cut can then flip one target
  pixel: one pixel of a target's union of ≥ ~10 pixels moves that trial's
  IoU by ≤ 0.1, the mean of 12 trials by ≤ 0.01 a flip.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mnc_tpu.data.eval_sds import collect_detections as j_collect
from mnc_tpu.data.eval_sds import eval_sds as j_eval_sds
from mnc_tpu.data.synth_imdb import SyntheticIMDB as JSyntheticIMDB
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch, propose_rois as j_propose_rois
from mnc_tpu.ops.bbox import bbox_overlaps as j_bbox_overlaps
from mnc_tpu.pipeline.inference import MNCPipeline as JPipeline
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.pipeline.inference import unpack_canvas_masks as j_unpack
from mnc_tpu.utils.checkpoint import save_npz as j_save_npz
from mnc_tpu_torch.tools import (ablation_study, crowd_study, mask_fidelity_study,
                                 workingset_study)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX tools' --smoke architecture (tools/crowd_study.py)
JSMOKE = JArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
               warp_hw=4, n_stages=5, fc_dim=48, mask_fc_dim=24, pre_nms_top_n=64,
               post_nms_top_n=16, rpn_min_size=4.0, compute_dtype=jnp.float32)
CROWD = ["--eval-images", "2", "--dets-per-class", "16", "--vote-top-k", "64", "0"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _records(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def jax_crowd():
    """``tools/crowd_study.py --smoke`` started as a subprocess (it runs
    while the parameters below are drawn)."""
    env = dict(os.environ, MNC_XLA_CACHE_DIR="off")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "crowd_study.py"),
                             "--smoke", *CROWD], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def smoke_params(tmp_path_factory, jax_crowd):
    """The JAX smoke model's parameters as the JAX tool draws them (no jit),
    and their npz."""
    params = JMNC(arch=JSMOKE).init(jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                                    jnp.array([96.0, 128.0, 1.0]))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    path = str(tmp_path_factory.mktemp("smoke") / "smoke.npz")
    j_save_npz(path, params)
    return params, path


def test_smoke_arch_is_the_jax_tools():
    a = ablation_study.smoke_arch()
    for f in dataclasses.fields(JArch):
        if hasattr(a, f.name) and f.name != "compute_dtype":
            assert getattr(a, f.name) == getattr(JSMOKE, f.name), f.name


def test_crowd_study_matches_the_jax_tool(smoke_params, jax_crowd):
    _, npz = smoke_params
    got = _records(_run(crowd_study.main, ["--smoke", "--device", "cpu", "--params", npz,
                                           *CROWD]))
    out, err = jax_crowd.communicate(timeout=600)
    assert jax_crowd.returncode == 0, out[-2000:] + err[-3000:]
    want = _records(out)
    assert [r["config"] for r in got] == [r["config"] for r in want] == [
        "dets_per_class=16,vote_top_k=64", "dets_per_class=16,vote_top_k=all"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("map_r_050", "map_r_070", "max_dets_per_image_class",
                  "instances_per_image", "n_images"):
            assert g[k] == w[k], (g["config"], k)
    assert got[0]["max_dets_per_image_class"] > 0


def _jax_point(params, arch, post, val_ex, gt, num_classes):
    """One workingset point composed of the JAX package's functions."""
    model = JMNC(arch=arch)
    pipe = JPipeline(model, params, post)
    anchors = jnp.asarray(arch.all_anchors())
    dets, best = [], []
    for i, ex in val_ex:
        img, info = jnp.asarray(ex["image"]), jnp.asarray(ex["im_info"])
        out = jax.device_get(pipe.detect_canvas_packed(img, info))
        dets.extend(j_collect(j_unpack(out, arch.canvas[1]), i, score_thresh=0.05))
        feat = model.apply(params, img, method=JMNC.features)
        rpn_cls, rpn_bbox = model.apply(params, feat, method=JMNC.rpn)
        rois, valid, _ = j_propose_rois(rpn_cls, rpn_bbox, info, anchors, arch)
        ov = jnp.where(valid[None, :], j_bbox_overlaps(jnp.asarray(ex["gt_boxes"]), rois), 0.0)
        best.extend(np.asarray(jnp.max(ov, axis=1))[ex["gt_valid"]].tolist())
    best = np.asarray(best)
    return {"recall@.5": round(float((best >= 0.5).mean()), 4),
            "recall@.7": round(float((best >= 0.7).mean()), 4),
            "map_r_050": round(j_eval_sds(dets, gt, num_classes, 0.5)["map"], 4),
            "map_r_070": round(j_eval_sds(dets, gt, num_classes, 0.7)["map"], 4)}


def test_workingset_study_matches_jax(smoke_params):
    params, npz = smoke_params
    argv = ["--smoke", "--device", "cpu", "--params", npz, "--eval-images", "2",
            "--pre-nms", "256", "--post-nms", "64", "--dets-per-class", "16"]
    got = _records(_run(workingset_study.main, argv))
    assert [r["config"] for r in got] == ["pre_nms=256,dets_per_class=16",
                                          "pre_nms=256,post_nms=64,dets_per_class=16"]
    val = JSyntheticIMDB(canvas_hw=JSMOKE.canvas, num_classes=JSMOKE.num_classes,
                         gt_mask_size=28, num_images=2, seed=99, max_gt=6)
    val_ex = [(i, val.example(i)) for i in val.image_index]
    gt = val.gt_instances()
    points = [(dataclasses.replace(JSMOKE, pre_nms_top_n=256), 100),
              (dataclasses.replace(JSMOKE, pre_nms_top_n=256, post_nms_top_n=64), 304)]
    for rec, (arch, max_per_image) in zip(got, points):
        post = JPostCfg(dets_per_class=16, max_per_image=max_per_image, vote_top_k=64,
                        score_thresh=0.01, paste_dtype="f32")
        want = _jax_point(params, arch, post, val_ex, gt, val.num_classes)
        assert {k: rec[k] for k in want} == want, rec["config"]
    assert got[1]["recall@.5"] > 0


def _table(stdout):
    rows = {}
    for ln in stdout.splitlines():
        parts = ln.split()
        if len(parts) == 5 and parts[1] in ("nearest", "area"):
            rows[int(parts[0]), parts[1]] = [float(v) for v in parts[2:]]
    return rows


def test_mask_fidelity_study_matches_the_jax_tool(monkeypatch):
    argv = ["--trials", "12", "--canvas", "96", "128", "--mask-size", "9"]
    got = _table(_run(mask_fidelity_study.main, [*argv, "--device", "cpu"]))
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import mask_fidelity_study as jtool
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["mask_fidelity_study.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtool.main()
    want = _table(buf.getvalue())
    assert set(got) == set(want) and len(got) == 8
    for (s, filt), w in want.items():
        if filt == "nearest":
            assert got[s, filt] == w, s
        else:
            assert abs(got[s, filt][0] - w[0]) <= 0.02, (s, got[s, filt], w)
            assert np.allclose(got[s, filt][1:], w[1:], rtol=0, atol=0.1), (s, got[s, filt], w)
