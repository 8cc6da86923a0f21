"""The serving slice against the JAX package, and the checkpoint directories.

- The same small params (seeded by the port, written with
  ``mnc_tpu.utils.checkpoint.save_npz`` and read back by each package's
  reader) go into both packages under the same cfg (a small f32 architecture, ``TEST.PASTE_DTYPE
  f32``).  The port's HTTP server as ``tools/serve.py --http`` builds it
  answers one image; the JAX side's reply is ``MNCPipeline.detect`` +
  ``mnc_tpu.native.rle_encode`` + the filter of ``tools/serve.py``.
  Tolerances: instance count and class ids equal; boxes within 0.1 px (the
  reply's rounding); scores within 1e-4; decoded masks differing on at most
  1e-4 of the pixels.
- ``serve.main`` in-process over ``.npy`` paths (and an unreadable one), and
  with ``--exported`` on ``export_model --program``'s artifact: the same
  lines as the live pipeline, exactly; without ``--device cpu`` it needs a
  GPU, as every entry point of the port does.
- Checkpoint directories: pruning, ``-tmp`` directories skipped, the newest
  found (on a two-layer stand-in for the model: the directory logic does
  not read the state), a restore bit-equal, ``train_net`` resuming from the
  newest step to the state of an uninterrupted run (bit for bit),
  ``test_net --ckpt``.

Only this file compiles JAX, once, in a module-scoped fixture.
"""

import io
import json
import os
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mnc_tpu import config as jconfig
from mnc_tpu import native as jnative
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.pipeline import inference as jinf
from mnc_tpu.utils.checkpoint import load_npz, save_npz
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch import native
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.tools import export_model, serve, test_net, train_net
from mnc_tpu_torch.train.loop import TrainState
from mnc_tpu_torch.train.optim import make_optimizer
from mnc_tpu_torch.utils import checkpoint as ckpt

SET = ["STATIC.CANVAS", "(64, 96)", "NET.ANCHOR_SCALES", "(1, 2, 4)", "NET.NUM_CLASSES", "4",
       "MASK_SIZE", "9", "NET.WARP_HW", "4", "NET.FC_DIM", "32", "NET.MASK_FC_DIM", "16",
       "NET.COMPUTE_DTYPE", "float32", "STATIC.TEST_PRE_NMS_TOP_N", "32",
       "STATIC.TEST_POST_NMS_TOP_N", "8", "TEST.RPN_MIN_SIZE", "2", "TEST.SCALES", "(48,)",
       "TEST.MAX_SIZE", "96", "TEST.PASTE_DTYPE", "f32"]
TRAIN_SET = ["NET.FC_DIM", "32", "NET.MASK_FC_DIM", "16", "NET.COMPUTE_DTYPE", "float32",
             "STATIC.TRAIN_PRE_NMS_TOP_N", "64", "STATIC.TRAIN_POST_NMS_TOP_N", "16",
             "TRAIN.BATCH_SIZE", "16", "TRAIN.SNAPSHOT_ITERS", "1"]


class restored_cfgs:
    """Both packages' cfg trees restored on exit."""

    def __enter__(self):
        self.saved = [(c, c.cfg.clone()) for c in (jconfig, pconfig)]

    def __exit__(self, *exc):
        for c, saved in self.saved:
            c.cfg.clear()
            c.cfg.update(saved)


def _images():
    rs = np.random.RandomState(2)
    return {"landscape": (rs.rand(60, 120, 3) * 255).astype(np.uint8),
            "scale one": (rs.rand(48, 96, 3) * 255).astype(np.uint8)}


def jax_reply(dets, conf):
    """The JAX package's reply, as ``tools/serve.py`` builds it."""
    instances = []
    for k in range(len(dets["scores"])):
        if not dets["valid"][k] or dets["scores"][k] < conf:
            continue
        rle = jnative.rle_encode(dets["full_masks"][k])
        instances.append({"box": [round(float(v), 1) for v in dets["boxes"][k]],
                          "class_id": int(dets["classes"][k]),
                          "score": round(float(dets["scores"][k]), 4),
                          "mask_rle": {"size": list(rle["size"]),
                                       "counts": rle["counts"].tolist()}})
    return {"instances": instances}


def _npy(im):
    buf = io.BytesIO()
    np.save(buf, im)
    return buf.getvalue()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX replies of every image, the port's server (as ``serve --http``
    builds it, on the same npz) and its pipeline; the cfgs stay set for the
    module's serving tests."""
    tmp = tmp_path_factory.mktemp("serve")
    with restored_cfgs():
        jconfig.cfg_from_list(SET)
        pconfig.cfg_from_list(SET)
        seeded = MNC(MNCArch.from_cfg(train=False), device="cpu", seed=0)
        npz = str(tmp / "params.npz")
        save_npz(npz, ckpt.jax_params_from_state_dict(seeded.state_dict()),
                 {"bbox_pred_normalized": True})
        jpipe = jinf.MNCPipeline(JMNC(arch=JArch.from_cfg(train=False)), load_npz(npz),
                                 jinf.PostCfg.from_cfg(score_thresh=0.0))
        want = {name: jax_reply(jpipe.detect(im), 0.0) for name, im in _images().items()}
        args = serve.parse_args(["--npz", npz, "--device", "cpu", "--conf", "0.0", "--http",
                                 "0", "--set", *SET])
        with pytest.warns(UserWarning, match="CAPPED"):
            pipe = serve.load_pipeline(args)
        srv = serve.build_server(args, pipe, host="127.0.0.1")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            yield dict(want=want, srv=srv, pipe=pipe, npz=npz, tmp=tmp)
        finally:
            srv.shutdown()
            srv.server_close()


@pytest.mark.parametrize("name", list(_images()))
def test_http_reply_matches_jax(served, name):
    port = served["srv"].server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect",
                                 data=_npy(_images()[name]), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        got = json.load(r)["instances"]
    want = served["want"][name]["instances"]
    assert want and len(got) == len(want)
    assert [g["class_id"] for g in got] == [w["class_id"] for w in want]
    np.testing.assert_allclose([g["box"] for g in got], [w["box"] for w in want], rtol=0,
                               atol=0.1 + 1e-6)
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want], rtol=0,
                               atol=1e-4)
    for g, w in zip(got, want):
        assert g["mask_rle"]["size"] == w["mask_rle"]["size"] == list(_images()[name].shape[:2])
        diff = native.rle_decode(g["mask_rle"]) != jnative.rle_decode(w["mask_rle"])
        assert diff.mean() <= 1e-4


def test_serve_main_over_npy_paths(served, tmp_path, capsys):
    paths = []
    for name, im in _images().items():
        paths.append(str(tmp_path / f"{name.replace(' ', '_')}.npy"))
        np.save(paths[-1], im)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((4, 4), np.uint8))
    capsys.readouterr()
    with restored_cfgs(), pytest.warns(UserWarning, match="CAPPED"):
        assert serve.main([*paths, bad, str(tmp_path / "missing.npy"), "--npz", served["npz"],
                           "--device", "cpu", "--conf", "0.2", "--set", *SET]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["image"] for ln in lines] == [*paths, bad, str(tmp_path / "missing.npy")]
    for ln, im in zip(lines, _images().values()):
        assert ln["instances"] == serve.dets_to_json(served["pipe"].detect(im), 0.2)["instances"]
    assert lines[-2]["error"] == lines[-1]["error"] == "unreadable"


def test_serve_main_exported(served, tmp_path, capsys):
    """``export_model --program`` on the npz, then ``serve --exported
    --device cpu``: the lines of the live pipeline.  Without ``--device
    cpu`` the CPU artifact is not served: the entry point asks for the GPU
    first."""
    program = str(tmp_path / "single.pt2")
    with restored_cfgs(), pytest.warns(UserWarning, match="CAPPED"):
        assert export_model.main(["--npz", served["npz"], "--out", str(tmp_path / "ex.npz"),
                                  "--program", program, "--device", "cpu", "--set", *SET]) == 0
    assert not ckpt.npz_meta(str(tmp_path / "ex.npz"))["bbox_pred_normalized"]
    images = _images()
    paths = []
    for name, im in images.items():
        paths.append(str(tmp_path / f"{name.replace(' ', '_')}.npy"))
        np.save(paths[-1], im)
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([*paths, "--exported", program])
    with restored_cfgs():
        pconfig.cfg_from_list(SET)
        assert serve.main([*paths, "--exported", program, "--device", "cpu", "--conf",
                           "0.0"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == len(images)
    for ln, im in zip(lines, images.values()):
        assert ln["instances"] == serve.dets_to_json(served["pipe"].detect(im), 0.0)["instances"]


# --------------------------------------------------------------------------- #
# checkpoint directories
# --------------------------------------------------------------------------- #


def _train_state(seed):
    arch = MNCArch(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
                   warp_hw=4, fc_dim=16, mask_fc_dim=8, pre_nms_top_n=32, post_nms_top_n=8,
                   compute_dtype=torch.float32)
    return _with_random_traces(MNC(arch, device="cpu", seed=seed, train=True), seed)


def _with_random_traces(model, seed, iter_size=2):
    state = TrainState.create(model, make_optimizer(model, base_lr=0.01, momentum=0.9,
                                                    weight_decay=5e-4, gamma=0.1,
                                                    stepsize=100, iter_size=iter_size))
    g = torch.Generator().manual_seed(seed)
    opt = state.opt.state_dict()
    for t in list(opt["trace"].values()) + list((opt["acc"] or {}).values()):
        t.copy_(torch.randn(t.shape, generator=g))
    return state


def test_checkpoint_dirs_prune_skip_tmp_and_find_the_newest(tmp_path):
    state = _with_random_traces(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                                    torch.nn.Linear(4, 2)), 0, iter_size=1)
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), state, step=step, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002", "ckpt_00000003"]
    os.makedirs(tmp_path / "ckpt_00000009-tmp")  # a save that died half-way
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_00000003")
    assert ckpt.checkpoint_npz(str(tmp_path)) == str(tmp_path / "ckpt_00000003" /
                                                     ckpt.STATE_FILE)
    state.step = 4
    assert ckpt.save_checkpoint(str(tmp_path), state, keep=2) == str(tmp_path / "ckpt_00000004")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003", "ckpt_00000004"]
    assert ckpt.latest_checkpoint(str(tmp_path / "nothing")) is None
    assert ckpt.restore_latest(str(tmp_path / "nothing"), state) == (state, 0)
    os.makedirs(tmp_path / "empty_run")
    with pytest.raises(FileNotFoundError):
        ckpt.checkpoint_npz(str(tmp_path / "empty_run"))


def test_checkpoint_restore_is_bit_equal(tmp_path):
    src = _train_state(0)
    src.step = 12
    ckpt.save_checkpoint(str(tmp_path), src, keep=2)
    dst = _train_state(1)
    dst, step = ckpt.restore_latest(str(tmp_path), dst)
    assert step == 12 and dst.step == 12
    for (n, a), (m, b) in zip(src.model.state_dict().items(), dst.model.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    so, do = src.opt.state_dict(), dst.opt.state_dict()
    assert (so["count"], so["mini_step"]) == (do["count"], do["mini_step"])
    for key in ("trace", "acc"):
        for name, t in so[key].items():
            assert torch.equal(t, do[key][name]), (key, name)


def test_train_net_resumes_from_the_newest_step(tmp_path, capsys):
    """An uninterrupted run of 2 steps keeps a snapshot of each; a second run
    directory that holds only the first snapshot resumes from it to 2 steps:
    the same final state, bit for bit; then test_net reads the newest step
    through --ckpt."""
    common = ["--imdb", "synthetic_4", "--device", "cpu", "--print-every", "100",
              "--iters", "2", "--set", *TRAIN_SET]

    def run(out):
        with restored_cfgs(), pytest.warns(UserWarning, match="CAPPED"):
            assert train_net.main([*common, "--out", str(out)]) == 0

    run(tmp_path / "b")
    assert sorted(os.listdir(tmp_path / "b")) == ["ckpt_00000001", "ckpt_00000002",
                                                  "train_metrics.jsonl"]
    shutil.copytree(tmp_path / "b" / "ckpt_00000001", tmp_path / "a" / "ckpt_00000001")
    capsys.readouterr()
    run(tmp_path / "a")
    assert "resumed from iter 1" in capsys.readouterr().out
    a = np.load(tmp_path / "a" / "ckpt_00000002" / ckpt.STATE_FILE)
    b = np.load(tmp_path / "b" / "ckpt_00000002" / ckpt.STATE_FILE)
    assert sorted(a.files) == sorted(b.files) and int(a["__meta__/step"]) == 2
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with restored_cfgs():
        assert test_net.main(["--imdb", "synthetic_4", "--device", "cpu", "--ckpt",
                              str(tmp_path / "a"), "--set", *TRAIN_SET[:6]]) == 0
    assert f"loaded params from {tmp_path / 'a' / 'ckpt_00000002' / ckpt.STATE_FILE}" in \
        capsys.readouterr().out
