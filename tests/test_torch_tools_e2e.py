"""The port's train → detect → mAP^r tools against the JAX package:
``mnc_tpu_torch/tools/e2e_synth_demo.py`` and ``ablation_study.py``, on the
CPU at their small configurations.

- ``e2e_synth_demo``: two steps with an evaluation after each, the final
  JSON line and the learning curve; its ``e2e_params.npz`` has the JAX
  ``MNC``'s parameter tree and shapes, and a JAX-saved npz works as
  ``--init-params`` (one of another shape is refused).
- ``ablation_study``: its variant loop (``run_variants``) on the JAX
  package's smoke initialisation, converted, against the JAX
  ``MNCPipeline`` on the same images for ``5stage``, ``3stage`` and
  ``5stage_voteboxes`` (the JAX side pastes in f32, as the port does):
  the same detections in the same order, classes identical, scores within
  1e-5, pasted masks equal but for 1e-3 of their pixels (a soft mask within
  1e-4 of the 0.4 threshold may land on either side), mAP^r within 1e-3;
  every record's fields, and the bootstrap store with paired deltas across
  two ``--only`` runs.
"""

import argparse
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mnc_tpu.data.eval_sds import collect_detections as j_collect
from mnc_tpu.data.eval_sds import eval_sds as j_eval_sds
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.pipeline.inference import MNCPipeline as JPipeline
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.pipeline.inference import unpack_canvas_masks as j_unpack
from mnc_tpu.utils.checkpoint import load_npz as j_load_npz
from mnc_tpu.utils.checkpoint import save_npz as j_save_npz
from mnc_tpu_torch.pipeline.inference import PostCfg
from mnc_tpu_torch.tools import ablation_study, e2e_synth_demo
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

E2E_SMALL = dict(canvas=(96, 128), anchor_scales=(1, 2, 4), num_classes=4, mask_size=13,
                 warp_hw=6, n_stages=5, compute_dtype=jnp.float32, fc_dim=256,
                 mask_fc_dim=256, pre_nms_top_n=192, post_nms_top_n=48, rpn_min_size=4.0,
                 trunk_frozen=0)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def test_e2e_synth_demo_small(tmp_path):
    out = tmp_path / "run"
    common = ["--train-images", "4", "--eval-images", "2", "--device", "cpu", "--out", str(out)]
    stdout = _run(e2e_synth_demo.main, ["--iters", "2", "--eval-every", "1", *common])
    final = json.loads(stdout.strip().splitlines()[-1])
    assert set(final) == {"map_r_050", "map_r_070", "iters", "batch"}
    assert (final["iters"], final["batch"]) == (2, 1)
    assert stdout.count("EVAL ") == 1 and "iter 1: total=" in stdout and "netdiag:" in stdout
    curve = [json.loads(ln) for ln in (out / "e2e_metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in curve] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in curve)
    assert curve[-1]["map_r_050"] == final["map_r_050"]

    # the npz is the JAX MNC's parameter tree
    jm = JMNC(arch=JArch(**E2E_SMALL))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                          jnp.array([96.0, 128.0, 1.0]))
    saved = j_load_npz(str(out / "e2e_params.npz"))
    assert _shapes(saved) == _shapes(want)

    # a JAX-saved npz starts a run; one of another shape is refused
    jparams = jax.tree_util.tree_map(lambda a: np.full(a.shape, 0.01, a.dtype), want)
    j_save_npz(str(tmp_path / "jax.npz"), jparams)
    stdout = _run(e2e_synth_demo.main, ["--iters", "0", "--init-params",
                                        str(tmp_path / "jax.npz"), *common])
    assert f"fine-tuning from {tmp_path / 'jax.npz'}" in stdout
    assert json.loads(stdout.strip().splitlines()[-1])["iters"] == 0
    bad = jparams
    bad["params"]["mask_head"]["mask_pred"]["bias"] = np.zeros(7, np.float32)
    j_save_npz(str(tmp_path / "bad.npz"), bad)
    with pytest.raises(SystemExit, match="shape mismatch"):
        _run(e2e_synth_demo.main, ["--iters", "0", "--init-params", str(tmp_path / "bad.npz"),
                                   *common])


@pytest.fixture(scope="module")
def ablation(tmp_path_factory):
    """The JAX smoke initialisation, the port's 8 variants on it, and the
    validation set they ran on."""
    tmp = tmp_path_factory.mktemp("ablation")
    args = ablation_study.parse_args(["--smoke", "--device", "cpu", "--val-seeds", "99", "7",
                                      "--bootstrap", "10", "--coco-ap", "--append",
                                      str(tmp / "abl.jsonl")])
    base = ablation_study.base_arch(args)
    jbase = JArch(**{f.name: getattr(base, f.name) for f in dataclasses.fields(JArch)
                     if hasattr(base, f.name) and f.name != "compute_dtype"},
                  compute_dtype=jnp.float32)
    params = jax.device_get(jax.jit(JMNC(arch=jbase).init)(
        jax.random.PRNGKey(0), jnp.zeros((*base.canvas, 3), jnp.float32),
        jnp.array([*base.canvas, 1.0])))
    params = jax.tree_util.tree_map(np.asarray, params)
    import torch

    with contextlib.redirect_stdout(io.StringIO()):
        records, dets = ablation_study.run_variants(params, args, torch.device("cpu"))
    return args, jbase, params, records, dets


@pytest.mark.parametrize("label", ["5stage", "3stage", "5stage_voteboxes"])
def test_ablation_variant_matches_jax(ablation, label):
    args, jbase, params, records, dets = ablation
    jpost0 = JPostCfg(dets_per_class=16, max_per_image=100, vote_top_k=64, score_thresh=0.01,
                      paste_dtype="f32")
    jarch, jpost = {"5stage": (jbase, jpost0),
                    "3stage": (dataclasses.replace(jbase, n_stages=3), jpost0),
                    "5stage_voteboxes": (jbase, dataclasses.replace(jpost0, vote_boxes=True))
                    }[label]
    pipe = JPipeline(JMNC(arch=jarch), params, jpost)
    val_ex, _, gt = ablation_study.validation_set(ablation_study.base_arch(args), args)
    want = []
    for iid, ex in val_ex:
        out = jax.device_get(pipe.detect_canvas_packed(jnp.asarray(ex["image"]),
                                                       jnp.asarray(ex["im_info"])))
        want.extend(j_collect(j_unpack(out, jarch.canvas[1]), iid, score_thresh=0.05))
    got = dets[label]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["class_id"]) == (w["image_id"], w["class_id"])
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert (g["mask"] != w["mask"]).mean() <= 1e-3
    rec = next(r for r in records if r["config"] == label)
    for key, thr in (("map_r_050", 0.5), ("map_r_070", 0.7)):
        assert abs(rec[key] - j_eval_sds(want, gt, jbase.num_classes, thr)["map"]) <= 1e-3


def test_ablation_records_and_paired_deltas(ablation):
    args, _, params, records, _ = ablation
    assert [r["config"] for r in records] == list(ablation_study.variants(
        ablation_study.base_arch(args), PostCfg()))
    keys = {"config", "map_r_050", "map_r_070", "ms_per_img", "pre_nms", "mask_size",
            "n_images", "val_seeds", "map_r_avg", "ci_050", "ci_070", "n_boot"}
    after_baseline = False  # paired deltas once the baseline's resamples are stored
    for r in records:
        assert keys <= set(r) and r["n_images"] == 4 and r["val_seeds"] == [99, 7]
        assert ("delta_050_vs_5stage" in r) == ("delta_070_vs_5stage" in r) == after_baseline
        after_baseline = after_baseline or r["config"] == "5stage"
    store = np.load(args.append + ".boot.npz")
    assert sorted(store.files) == sorted(f"{r['config']}:{k}" for r in records
                                         for k in ("050", "070"))
    # a later --only process pairs against the stored baseline
    import torch

    only = argparse.Namespace(**{**vars(args), "only": "3stage"})
    with contextlib.redirect_stdout(io.StringIO()):
        (rec,), _ = ablation_study.run_variants(params, only, torch.device("cpu"))
    first = next(r for r in records if r["config"] == "3stage")
    assert {k: v for k, v in rec.items() if k != "ms_per_img" and "delta" not in k} == {
        k: v for k, v in first.items() if k != "ms_per_img"}
    d = np.load(args.append + ".boot.npz")
    mean = float((d["3stage:050"] - d["5stage:050"]).mean())
    assert rec["delta_050_vs_5stage"][0] == round(mean, 4)
    lines = open(args.append).read().splitlines()
    assert len(lines) == len(records) + 1 and json.loads(lines[-1])["config"] == "3stage"


@pytest.mark.parametrize("arch_kw", [{}, dict(trunk="resnet50", roi_conv5=True,
                                              int8_inference=True)])
def test_model_without_init_serves_the_loaded_weights(arch_kw):
    """``MNC(seed=None)`` (what the tools build before loading a state dict)
    skips the random init and gives the outputs of the model it loaded."""
    import torch

    from mnc_tpu_torch.models.mnc import MNC, MNCArch

    arch = MNCArch(canvas=(64, 96), num_classes=4, mask_size=9, warp_hw=4, fc_dim=32,
                   mask_fc_dim=16, pre_nms_top_n=64, post_nms_top_n=16,
                   compute_dtype=torch.float32, **arch_kw)
    ref = MNC(arch, device="cpu", seed=3)
    model = MNC(arch, device="cpu", seed=None)
    model.load_state_dict(ref.state_dict())
    im = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (64, 96, 3)).astype(np.uint8))
    info = torch.tensor([64.0, 96.0, 1.0])
    want, got = ref(im, info), model(im, info)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

