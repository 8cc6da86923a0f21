"""The port's parallel slice (``mnc_tpu_torch/parallel``) on gloo groups of
CPU processes, against the single-process port and against the JAX
package's ``mnc_tpu/parallel`` on its 8-device CPU mesh.

Each rank is a subprocess (``tests/torch_dist_worker.py``, one torch
thread) that joins its group through a ``file://`` store under the test's
``tmp_path`` (TCP ports would race between xdist workers) and writes its
results to an npz; a group times out after 120 s.  The models are the small
f32 cascade of ``tests/test_parallel.py`` (96×128 canvas, 3 stages, fc 48,
mask fc 24) on its synthetic shapes.

Tolerances, f32 throughout (no looser than ``tests/test_parallel.py``'s):
the DP and hybrid steps against one process — ``total`` within 1e-5
relative, every other metric within 1e-4 relative (1e-6 absolute), every
parameter within 5e-4 relative (1e-6 absolute), the DP replicas bit for
bit equal; against the JAX DP step the same bounds.  ``train_net --dp``'s
first step as the DP step (its later steps start from parameters that
differ by rounding, and a discrete selection may flip); its resumed run bit
for bit.  Spatial features within
1e-5 of the map's max (the convolutions on row slabs sum as the whole-image
ones do, in other orders).  DP eval bit for bit against the one-image
runner on each image; the int8 features bit for bit against JAX's
``data_parallel_eval_step`` evaluated op by op.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mnc_tpu_torch.data.synthetic import SyntheticShapes
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.parallel import mnc_tp_shardings
from mnc_tpu_torch.train.loop import TrainState, make_train_step
from mnc_tpu_torch.train.optim import make_optimizer
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")

ARCH_KW = dict(canvas=[96, 128], anchor_scales=[2, 4, 8], num_classes=4, mask_size=9,
               warp_hw=4, n_stages=3, compute_dtype="float32", fc_dim=48, mask_fc_dim=24,
               pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0)
TRAIN_CFG = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                 RPN_FG_FRACTION=0.5, BATCH_SIZE=32, FG_FRACTION=0.25, FG_THRESH=0.5,
                 BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
DATA = SyntheticShapes(canvas_hw=(96, 128), num_classes=4, max_gt=4, gt_mask_size=16,
                       n_range=(1, 2), seed=5)
SMALL_CLI = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32",
             "STATIC.TRAIN_PRE_NMS_TOP_N", "256", "STATIC.TRAIN_POST_NMS_TOP_N", "64"]


def arch(**over) -> MNCArch:
    kw = dict(ARCH_KW, **over)
    kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    kw["canvas"], kw["anchor_scales"] = tuple(kw["canvas"]), tuple(kw["anchor_scales"])
    return MNCArch(**kw)


def _wait(procs, what, timeout=240):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{out[-4000:]}"
    return outs


def run_ranks(tmp_path, scenario, world, spec, arrays) -> list:
    """``world`` worker processes of ``scenario``; each rank's npz."""
    base = tmp_path / f"{scenario}_{world}"
    in_dir, out_dir = base / "in", base / "out"
    in_dir.mkdir(parents=True)
    out_dir.mkdir()
    (in_dir / "spec.json").write_text(json.dumps(spec))
    np.savez(in_dir / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, str(base / "pg"), str(r),
                               str(world), str(in_dir), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for r in range(world)]
    _wait(procs, scenario)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def batch_arrays(n) -> dict:
    return {f"batch/{k}": v for k, v in DATA.batch(range(n)).items()}


def single_process_step(state_dict, n_images, seed, opt_kw):
    """The port's plain step on the global batch, the draws from a CPU
    generator seeded as the ranks seed theirs: (metrics, state dict)."""
    a = arch()
    model = MNC(a, device="cpu", train=True)
    model.load_state_dict(state_dict)
    opt = make_optimizer(model, **opt_kw)
    step = make_train_step(model, opt, a, TRAIN_CFG)
    batch = {k: torch.from_numpy(v) for k, v in DATA.batch(range(n_images)).items()}
    _, metrics = step(TrainState.create(model, opt), batch, torch.Generator().manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


def assert_metrics(got: dict, want: dict, what: str):
    assert set(got) == set(want), (set(got), set(want))
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-5, err_msg=what)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: metric {k}")


def assert_params(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=1e-6,
                                   err_msg=f"{what}: param {k}")


def _metrics(rank_out: dict) -> dict:
    return {k[len("metric/"):]: float(v) for k, v in rank_out.items()
            if k.startswith("metric/")}


def _params(rank_out: dict) -> dict:
    return {k[len("sd/"):]: v for k, v in rank_out.items() if k.startswith("sd/")}


# ---------------------------------------------------------------------------
# data parallel = one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,clip", [(2, -1.0), (4, 2.0)], ids=["2x1", "4x1-clip"])
def test_dp_step_equals_the_single_process_step(tmp_path, world, clip):
    """``world`` ranks × 1 image against the port's ``world``-image step on
    the same draws (the global batch's, from one seed): losses and every
    parameter after the step; the replicas stay identical.  The 4-rank case
    clips at a norm the global gradient exceeds."""
    model = MNC(arch(), device="cpu", seed=3, train=True)
    opt_kw = {"clip_gradients": clip}
    spec = {"arch": ARCH_KW, "train_cfg": TRAIN_CFG, "opt": opt_kw, "seed": 11,
            "model_seed": 3}
    outs = run_ranks(tmp_path, "dp", world, spec, batch_arrays(world))
    want_m, want_p = single_process_step(model.state_dict(), world, 11, opt_kw)
    assert_metrics(_metrics(outs[0]), want_m, f"DP {world}")
    assert_params(_params(outs[0]), want_p, f"DP {world}")
    for r in range(1, world):  # each replica's digests against rank 0's parameters
        for k, v in _params(outs[0]).items():
            assert str(_params(outs[r])[k]) == hashlib.sha1(v.tobytes()).hexdigest(), \
                f"replica {r}: {k}"
        assert _metrics(outs[r]) == _metrics(outs[0])
    moved = max(np.abs(want_p[k] - model.state_dict()[k].numpy()).max() for k in want_p)
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# hybrid DP × TP = one process
# ---------------------------------------------------------------------------


def test_tp_shardings_follow_the_jax_rule():
    """Column-parallel fc6/fc_mask on the outputs (dim 0 of the torch
    weight, with the bias), row-parallel fc7/mask_pred on the inputs (dim 1;
    the bias replicated), everything else replicated."""
    spec = mnc_tp_shardings(MNC(arch(), device="cpu", train=True))
    assert spec["classify_head.fc6.weight"] == (0, "model")
    assert spec["classify_head.fc6.bias"] == (0, "model")
    assert spec["mask_head.fc_mask.weight"] == (0, "model")
    assert spec["classify_head.fc7.weight"] == (1, "model")
    assert spec["mask_head.mask_pred.weight"] == (1, "model")
    assert spec["classify_head.fc7.bias"] is None
    assert spec["mask_head.mask_pred.bias"] is None
    sharded = {k for k, v in spec.items() if v is not None}
    assert len(sharded) == 6, sharded
    assert spec["trunk.conv5_3.weight"] is None and spec["classify_head.cls_score.weight"] is None


def test_hybrid_step_equals_the_single_process_step(tmp_path):
    """A {data: 2, model: 2} mesh over 4 ranks, 2 images: every leaf (each
    rank's fc shards against the single-process leaf's slice) and the
    metrics; the ranks of one model index hold the same shard; the TP
    checkpoint (gathered, written by rank 0) holds what the single-process
    step's ``save_checkpoint`` holds.  Clipping binds, so the global norm
    must count the shards of every rank once."""
    from mnc_tpu_torch.utils.checkpoint import save_checkpoint

    model = MNC(arch(), device="cpu", seed=4, train=True)
    opt_kw = {"clip_gradients": 2.0}
    spec = {"arch": ARCH_KW, "train_cfg": TRAIN_CFG, "opt": opt_kw, "seed": 12,
            "model_seed": 4, "whole_ranks": [0, 1, 2, 3]}
    outs = run_ranks(tmp_path, "hybrid", 4, spec, batch_arrays(2))
    want_m, want_p = single_process_step(model.state_dict(), 2, 12, opt_kw)
    shard = mnc_tp_shardings(model)
    for r, out in enumerate(outs):
        assert_metrics(_metrics(out), want_m, f"hybrid rank {r}")
        got = _params(out)
        j = r % 2  # the model index of rank r on a row-major {data, model} mesh
        for k, want in want_p.items():
            if shard[k] is not None:
                dim = shard[k][0]
                w = want.shape[dim] // 2
                assert got[k].shape[dim] == w, (k, got[k].shape)
                want = np.take(want, range(j * w, (j + 1) * w), axis=dim)
            np.testing.assert_allclose(got[k], want, rtol=5e-4, atol=1e-6,
                                       err_msg=f"rank {r}: {k}")
    for k in want_p:  # ranks 0 and 2 (data 0 and 1, model 0) hold the same shard
        np.testing.assert_array_equal(_params(outs[0])[k], _params(outs[2])[k])

    # the TP checkpoint against the single-process one
    a = arch()
    ref = MNC(a, device="cpu", train=True)
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in want_p.items()})
    single = save_checkpoint(str(tmp_path / "single"), TrainState(1, ref, make_optimizer(ref)),
                             step=1)
    tp = np.load(tmp_path / "hybrid_4" / "out" / "ckpt" / "ckpt_00000001" / "train_state.npz")
    ref_npz = np.load(os.path.join(single, "train_state.npz"))
    assert set(tp.files) == set(ref_npz.files)
    for k in ref_npz.files:
        if k.startswith("params/"):
            np.testing.assert_allclose(tp[k], ref_npz[k], rtol=5e-4, atol=1e-6, err_msg=k)
    assert int(tp["__meta__/step"]) == 1 and int(tp["__meta__/opt_count"]) == 1
    fc6 = "__opt__/trace/classify_head/fc6/kernel"
    assert tp[fc6].shape == ref_npz[fc6].shape and np.abs(tp[fc6]).max() > 0


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _launch_tool(tmp_path, tool, world, argv, tag):
    init = tmp_path / f"pg_{tag}"
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"mnc_tpu_torch.tools.{tool}", *argv, "--dp", "--device",
             "cpu", "--dist-init", f"file://{init}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    return _wait(procs, f"{tool} {tag}")


def test_train_net_and_test_net_dp_on_two_ranks(tmp_path):
    """``train_net --dp`` on 2 CPU ranks (``--ims-per-batch 1`` raised to 2)
    for 3 steps, snapshots at 2 and 3: its first step equal to the
    single-process tool's within the DP step's tolerances, and a second run
    resumed from the step-2 snapshot equal to it at step 3 bit for bit; then
    ``test_net --dp --eval-batch 4`` on the trained state: the banner and an
    AP table from rank 0 only."""
    from mnc_tpu_torch.tools import train_net

    run, resumed = tmp_path / "run", tmp_path / "resumed"
    base = ["--imdb", "synthetic_8", "--print-every", "1", "--iters", "3", "--set", *SMALL_CLI]
    first = _launch_tool(tmp_path, "train_net", 2, [
        "--ims-per-batch", "1", "--out", str(run), *base, "TRAIN.SNAPSHOT_ITERS", "2"], "a")
    assert "data parallel over 2 devices, batch 2" in first[0], first[0]
    assert "Iteration 3" in first[0] and "Iteration" not in first[1], first[1]
    (resumed / "ckpt_00000002").mkdir(parents=True)
    shutil.copy(run / "ckpt_00000002" / "train_state.npz", resumed / "ckpt_00000002")
    second = _launch_tool(tmp_path, "train_net", 2, [
        "--ims-per-batch", "2", "--out", str(resumed), *base], "b")
    assert "resumed from iter 2" in second[0], second[0]
    dp = [json.loads(ln) for ln in (run / "train_metrics.jsonl").read_text().splitlines()]
    again = json.loads((resumed / "train_metrics.jsonl").read_text().splitlines()[-1])
    assert [r["step"] for r in dp] == [1, 2, 3] and again["step"] == 3
    keys = [k for k in dp[0] if k not in ("step", "time", "lr")]
    assert {k: again[k] for k in keys} == {k: dp[2][k] for k in keys}

    plain = tmp_path / "plain"
    assert train_net.main(["--imdb", "synthetic_8", "--iters", "1", "--ims-per-batch", "2",
                           "--device", "cpu", "--print-every", "100", "--out", str(plain),
                           "--set", *SMALL_CLI]) == 0
    ref = json.loads((plain / "train_metrics.jsonl").read_text())
    assert_metrics({k: dp[0][k] for k in keys}, {k: ref[k] for k in keys}, "train_net step 1")

    evals = _launch_tool(tmp_path, "test_net", 2, [
        "--imdb", "synthetic_8", "--ckpt", str(run), "--eval-batch", "4", "--set",
        "NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32"], "c")
    assert "--dp: eval batches of 4 sharded over 2 devices" in evals[0], evals[0]
    assert "mAP^r@0.5" in evals[0] and "mAP^r@0.5" not in evals[1], evals
    for d in (run, resumed, plain):  # the snapshots (~100 MB each) are not kept
        shutil.rmtree(d)


def test_dp_flags_are_checked(tmp_path):
    """``--segdb`` with ``--dp`` raises; ``--eval-batch`` must be a multiple
    of the world size (one rank: any); a real imdb does not take ``--dp``."""
    from mnc_tpu_torch.tools import test_net, train_net

    with pytest.raises(SystemExit, match="does not support --dp"):
        train_net.main(["--imdb", "synthetic_8", "--segdb", str(tmp_path), "--dp",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="synthetic imdb"):
        test_net.main(["--imdb", "voc_2012_seg_val", "--dp", "--device", "cpu"])
