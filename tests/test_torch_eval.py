"""Evaluation of the port against the JAX package: the mAP^r evaluator
(``eval_sds``, its per-image decomposition, the bootstrap, the averaged
AP^r@[.5:.95]) on ``tests/test_data_eval.py``'s cases, the synthetic imdb,
``get_imdb``, the timer, metrics logger and overlay, and the port's
``test_net`` on ``synthetic_8`` with one npz against the JAX functions that
``tools/test_net.py`` runs (f32 both sides, the JAX paste in f32).

Evaluator outputs must be equal (the same float64 arithmetic on the same
matches); ``test_net``'s AP table must be the same text, and its cached
detections the same selections with scores within 1e-5.
"""

import contextlib
import io
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mnc_tpu import config as jconfig
from mnc_tpu.data import eval_sds as jeval
from mnc_tpu.data.synth_imdb import SyntheticIMDB as JSyntheticIMDB
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch.data import eval_sds as peval
from mnc_tpu_torch.data.imdb import get_imdb
from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)


def _blob_mask(h, w, y1, y2, x1, x2):
    m = np.zeros((h, w), np.uint8)
    m[y1:y2, x1:x2] = 1
    return m


def _hand_cases():
    """The hand-built cases of tests/test_data_eval.py: perfect, a false
    positive and a miss, a duplicate, the averaged-threshold squares."""
    perfect_gt = {
        "a": [{"class_id": 1, "mask": _blob_mask(32, 32, 2, 12, 3, 13)},
              {"class_id": 2, "mask": _blob_mask(32, 32, 18, 30, 16, 28)}],
        "b": [{"class_id": 1, "mask": _blob_mask(32, 32, 5, 20, 5, 20)}]}
    perfect = [{"image_id": i, "class_id": g["class_id"], "score": 0.9, "mask": g["mask"]}
               for i, lst in perfect_gt.items() for g in lst]
    fp_gt = {"a": [{"class_id": 1, "mask": _blob_mask(32, 32, 2, 12, 3, 13)},
                   {"class_id": 1, "mask": _blob_mask(32, 32, 20, 30, 20, 30)}]}
    fp = [{"image_id": "a", "class_id": 1, "score": 0.9,
           "mask": _blob_mask(32, 32, 2, 12, 3, 13)},
          {"image_id": "a", "class_id": 1, "score": 0.5,
           "mask": _blob_mask(32, 32, 0, 2, 28, 32)}]
    m = _blob_mask(32, 32, 2, 12, 3, 13)
    dup = [{"image_id": "a", "class_id": 1, "score": s, "mask": m} for s in (0.9, 0.8)]
    sq = lambda y, x, s: _blob_mask(40, 40, y, y + s, x, x + s)  # noqa: E731
    sq_gt = {0: [{"class_id": 1, "mask": sq(0, 0, 12)}, {"class_id": 2, "mask": sq(20, 20, 10)}]}
    squares = [{"image_id": 0, "class_id": 1, "score": 0.9, "mask": sq(0, 2, 12)},
               {"image_id": 0, "class_id": 2, "score": 0.8, "mask": sq(0, 0, 10)}]
    return {"perfect": (perfect, perfect_gt, 3), "fp and miss": (fp, fp_gt, 2),
            "duplicate": (dup, {"a": fp_gt["a"][:1]}, 2), "squares": (squares, sq_gt, 3)}


def _random_eval_case(seed, n_images=12, num_classes=4, hw=(24, 32)):
    """tests/test_data_eval.py's random dets and gt with overlapping masks."""
    rs = np.random.RandomState(seed)
    gt, dets = {}, []
    for img in range(n_images):
        insts = []
        for _ in range(rs.randint(0, 4)):
            m = np.zeros(hw, np.uint8)
            y, x = rs.randint(0, hw[0] - 8), rs.randint(0, hw[1] - 8)
            m[y:y + rs.randint(4, 9), x:x + rs.randint(4, 9)] = 1
            insts.append({"class_id": rs.randint(1, num_classes), "mask": m})
        gt[img] = insts
        for _ in range(rs.randint(0, 5)):
            if insts and rs.rand() < 0.6:
                src = insts[rs.randint(len(insts))]
                m = src["mask"].copy()
                m[rs.randint(hw[0]), rs.randint(hw[1])] ^= 1
                cls = src["class_id"]
            else:
                m = np.zeros(hw, np.uint8)
                y, x = rs.randint(0, hw[0] - 6), rs.randint(0, hw[1] - 6)
                m[y:y + 5, x:x + 5] = 1
                cls = rs.randint(1, num_classes)
            dets.append({"image_id": img, "class_id": cls, "score": float(rs.rand()),
                         "mask": m})
    return dets, gt


CASES = {**_hand_cases(), **{f"random {s}": (*_random_eval_case(s), 4) for s in range(5)}}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluator_matches_jax(case):
    dets, gt, nc = CASES[case]
    for t in (0.5, 0.7):
        got, want = peval.eval_sds(dets, gt, nc, t), jeval.eval_sds(dets, gt, nc, t)
        assert got == want
        assert peval.print_ap_table(got) == jeval.print_ap_table(want)
        for use_07 in (False, True):
            assert (peval.eval_sds(dets, gt, nc, t, use_07_metric=use_07)
                    == jeval.eval_sds(dets, gt, nc, t, use_07_metric=use_07))
        m_got, m_want = (peval.eval_sds_matches(dets, gt, nc, t),
                         jeval.eval_sds_matches(dets, gt, nc, t))
        ids = list(gt)
        assert peval.map_from_matches(m_got, ids * 2) == jeval.map_from_matches(m_want, ids * 2)
        assert abs(peval.map_from_matches(m_got, ids) - got["map"]) < 1e-12
    assert peval.eval_sds_averaged(dets, gt, nc) == jeval.eval_sds_averaged(dets, gt, nc)


def test_hand_cases_give_the_known_values():
    cases = _hand_cases()
    assert peval.eval_sds(*cases["perfect"])["map"] == 1.0
    np.testing.assert_allclose(peval.eval_sds(*cases["fp and miss"])["map"], 0.5, atol=1e-6)
    np.testing.assert_allclose(peval.eval_sds(*cases["duplicate"])["ap"][1], 1.0, atol=1e-6)
    r = peval.eval_sds_averaged(*cases["squares"])
    assert r["ap"][1] == pytest.approx(0.5) and r["ap"][2] == 0.0
    assert r["per_thresh"][0.5] == 0.5 and r["thresh"] == "0.50:0.95"
    np.testing.assert_allclose(peval.voc_ap(np.array([0.2, 0.4, 0.6]),
                                            np.array([1.0, 0.5, 0.75])), 0.5, atol=1e-6)


def test_bootstrap_matches_jax():
    dets, gt = _random_eval_case(4)
    ids = list(gt)
    resamples = np.random.RandomState(0).randint(0, len(ids), size=(50, len(ids)))
    got = peval.bootstrap_map_ci(peval.eval_sds_matches(dets, gt, 4, 0.5), ids,
                                 resamples=resamples)
    want = jeval.bootstrap_map_ci(jeval.eval_sds_matches(dets, gt, 4, 0.5), ids,
                                  resamples=resamples)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1][0] <= got[1][1]
    seeded = peval.bootstrap_map_ci(peval.eval_sds_matches(dets, gt, 4, 0.5), ids, n_boot=20)
    np.testing.assert_array_equal(seeded[0], jeval.bootstrap_map_ci(
        jeval.eval_sds_matches(dets, gt, 4, 0.5), ids, n_boot=20)[0])


def test_mask_iou_matrix_matches_the_jax_fallback():
    rs = np.random.RandomState(1)
    a, b = rs.rand(5, 20, 30) > 0.6, rs.rand(3, 20, 30) > 0.3
    b[0] = False  # an empty mask: union clamps to 1
    a8 = a.reshape(5, -1).astype(np.uint8)
    b8 = b.reshape(3, -1).astype(np.uint8)
    inter = (a8[:, None] & b8[None]).sum(-1).astype(np.float32)
    union = (a8[:, None] | b8[None]).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(peval.mask_iou_matrix(a, b), inter / np.maximum(union, 1.0))


def test_synthetic_imdb_matches_jax():
    kw = dict(canvas_hw=(64, 80), num_classes=4, max_gt=3, gt_mask_size=16, num_images=3,
              seed=5)
    got, want = SyntheticIMDB(**kw), JSyntheticIMDB(**kw)
    assert (got.name, got.classes, got.image_index) == (want.name, want.classes,
                                                        want.image_index)
    for g, w in zip(got.roidb(), want.roidb()):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(got.maskdb(), want.maskdb()):
        np.testing.assert_array_equal(g["masks"], w["masks"])
    gi, wi = got.gt_instances(), want.gt_instances()
    assert gi.keys() == wi.keys()
    for i in gi:
        assert [g["class_id"] for g in gi[i]] == [w["class_id"] for w in wi[i]]
        for g, w in zip(gi[i], wi[i]):
            np.testing.assert_array_equal(g["mask"], w["mask"])
    dets = [{"image_id": i, "class_id": g["class_id"], "score": 0.9, "mask": g["mask"]}
            for i, gs in gi.items() for g in gs]
    res = got.evaluate(dets, iou_threshs=(0.5, "avg"))
    assert res == want.evaluate(dets, iou_threshs=(0.5, "avg"))
    assert res[0.5]["map"] == pytest.approx(1.0)
    entry, masks = got.flip_entry(got.roidb()[0], got.maskdb()[0], 80)
    want_entry, want_masks = want.flip_entry(want.roidb()[0], want.maskdb()[0], 80)
    np.testing.assert_array_equal(entry["boxes"], want_entry["boxes"])
    np.testing.assert_array_equal(masks["masks"], want_masks["masks"])


def test_get_imdb_knows_synthetic_only():
    """The synthetic names, and since the real-format readers were ported the
    VOC, SBD and COCO names too (``tests/test_torch_real_data.py`` holds
    their records against the JAX readers)."""
    from mnc_tpu_torch.data.coco import COCOSeg
    from mnc_tpu_torch.data.pascal_voc import PascalVOCDet, PascalVOCSeg

    assert get_imdb("synthetic_8").num_images == 8 and get_imdb("synthetic").num_images == 64
    for name, kind in (("voc_2012_train", PascalVOCDet), ("voc_2012_seg_val", PascalVOCSeg),
                       ("coco_2014_minival", COCOSeg)):
        imdb = get_imdb(name)
        assert isinstance(imdb, kind) and imdb.name == name
    with pytest.raises(KeyError):
        get_imdb("imagenet")


def test_timer_metrics_and_vis(tmp_path):
    from mnc_tpu.utils.vis import vis_seg as jvis
    from mnc_tpu_torch.utils.metrics import MetricsLogger
    from mnc_tpu_torch.utils.timer import Timer, device_timer
    from mnc_tpu_torch.utils.vis import vis_seg

    t = Timer()
    for _ in range(3):
        t.tic()
        t.toc()
    assert t.calls == 3 and t.average_time == t.total_time / 3
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            device_timer(lambda: None)
    log = MetricsLogger(str(tmp_path / "m" / "log.jsonl"), print_every=2)
    log.log(2, {"loss": 0.5}, lr=0.001)
    log.close()
    rec = json.loads((tmp_path / "m" / "log.jsonl").read_text())
    assert rec["step"] == 2 and rec["loss"] == 0.5 and rec["lr"] == 0.001
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    dets = {"scores": np.array([0.9, 0.2, 0.8]), "valid": np.array([True, True, False]),
            "classes": np.array([1, 2, 3]),
            "boxes": np.array([[2, 3, 30, 20], [0, 0, 49, 39], [5, 5, 9, 9]], np.float32),
            "full_masks": (rs.rand(3, 40, 50) > 0.5).astype(np.uint8)}
    np.testing.assert_array_equal(vis_seg(img, dets, score_thresh=0.5),
                                  jvis(img, dets, score_thresh=0.5))


# --------------------------------------------------------------------------- #
# test_net against the JAX functions of tools/test_net.py
# --------------------------------------------------------------------------- #

SMALL_CFG = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32"]


@contextlib.contextmanager
def _port_cfg_restored():
    saved = pconfig.cfg.clone()
    try:
        yield
    finally:
        pconfig.cfg.clear()
        pconfig.cfg.update(saved)


def _jax_test_net(npz_path, n_images):
    """What tools/test_net.py computes for --imdb synthetic_N --npz PATH
    (single canvas), with its own functions."""
    from mnc_tpu.data.pascal_voc import get_imdb as jget_imdb
    from mnc_tpu.models.mnc import MNC, MNCArch
    from mnc_tpu.pipeline.inference import MNCPipeline, PostCfg
    from mnc_tpu.utils.checkpoint import load_import_weights

    old = (jconfig.cfg.NET.FC_DIM, jconfig.cfg.NET.MASK_FC_DIM, jconfig.cfg.NET.COMPUTE_DTYPE,
           jconfig.cfg.TEST.PASTE_DTYPE)
    try:
        jconfig.cfg_from_list(SMALL_CFG + ["TEST.PASTE_DTYPE", "f32"])
        imdb = jget_imdb(f"synthetic_{n_images}")
        arch = MNCArch.from_cfg(train=False, n_stages=5, canvas=imdb.gen.canvas_hw,
                                num_classes=imdb.num_classes, anchor_scales=(2, 4, 8),
                                rpn_min_size=4.0)
        params, arch = load_import_weights(None, npz_path, arch, None)
        pipe = MNCPipeline(MNC(arch=arch), params, PostCfg.from_cfg(score_thresh=0.0))
        dets = []
        for i in imdb.image_index:
            ex = imdb.example(i)
            out = jax.device_get(pipe.detect_canvas(jnp.asarray(ex["image"]),
                                                    jnp.asarray(ex["im_info"])))
            dets.extend(jeval.collect_detections(out, i, 0.0))
        results = imdb.evaluate(dets, iou_threshs=(0.5, 0.7))
    finally:
        (jconfig.cfg.NET.FC_DIM, jconfig.cfg.NET.MASK_FC_DIM, jconfig.cfg.NET.COMPUTE_DTYPE,
         jconfig.cfg.TEST.PASTE_DTYPE) = old
    text = "\n".join(jeval.print_ap_table(r, imdb.classes) for r in results.values())
    return dets, text + "\n" + (f"mAP^r@0.5 = {results[0.5]['map']:.4f}  "
                                f"mAP^r@0.7 = {results[0.7]['map']:.4f}")


@pytest.fixture(scope="module")
def test_net_runs(tmp_path_factory):
    """One npz of JAX-initialized params; the port's test_net on it (single
    canvas and ragged packed batches of 3); the JAX functions on it."""
    from mnc_tpu.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.tools import test_net

    d = tmp_path_factory.mktemp("test_net")
    arch = MNCArch(canvas=(128, 160), num_classes=6, anchor_scales=(2, 4, 8), rpn_min_size=4.0,
                   fc_dim=64, mask_fc_dim=32, compute_dtype=jnp.float32)
    params = MNC(arch=arch).init(jax.random.PRNGKey(1), jnp.zeros((128, 160, 3)),
                                 jnp.array([128.0, 160.0, 1.0]))
    npz = str(d / "params.npz")
    save_npz(npz, params, {"bbox_pred_normalized": True})
    runs = {}
    for batch in (1, 3):
        buf, cache = io.StringIO(), str(d / f"dets_{batch}.pkl")
        with _port_cfg_restored(), contextlib.redirect_stdout(buf):
            assert test_net.main(["--imdb", "synthetic_8", "--npz", npz, "--device", "cpu",
                                  "--eval-batch", str(batch), "--cache", cache,
                                  "--set", *SMALL_CFG]) == 0
        with open(cache, "rb") as f:
            runs[batch] = (pickle.load(f), buf.getvalue())
    return runs, _jax_test_net(npz, 8)


def _table(stdout: str) -> str:
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~ Evaluation"))
    return "\n".join(lines[start:])


@pytest.mark.parametrize("batch", [1, 3])
def test_test_net_prints_the_jax_ap_table(test_net_runs, batch):
    runs, (jdets, jtext) = test_net_runs
    dets, stdout = runs[batch]
    assert _table(stdout) == jtext
    assert "mAP^r@0.5 = " in stdout and "loaded params from" in stdout
    assert len(dets) == len(jdets) > 0
    for g, w in zip(dets, jdets):
        assert (g["image_id"], g["class_id"]) == (w["image_id"], w["class_id"])
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert (g["mask"] != w["mask"]).mean() < 1e-3


def test_test_net_reads_its_cache_and_refuses_real_imdbs(test_net_runs, tmp_path):
    from mnc_tpu_torch.tools import test_net

    runs, (_, jtext) = test_net_runs
    cache = str(tmp_path / "dets.pkl")
    with open(cache, "wb") as f:
        pickle.dump(runs[1][0], f)
    buf = io.StringIO()
    with _port_cfg_restored(), contextlib.redirect_stdout(buf):
        test_net.main(["--imdb", "synthetic_8", "--cache", cache, "--device", "cpu",
                       "--coco-ap", "--set", *SMALL_CFG])
    out = buf.getvalue()
    assert f"loaded {len(runs[1][0])} cached detections" in out
    assert "AP^r@[.5:.95] = " in out and jtext.splitlines()[-1] in out
    # a real imdb is read from its files: missing ones are an error that names them
    with _port_cfg_restored(), pytest.raises(FileNotFoundError, match="voc_2012_val|val.txt"):
        test_net.main(["--imdb", "voc_2012_val", "--device", "cpu", "--set", "DATA_DIR",
                       str(tmp_path / "no_data")])


def test_demo_synthetic_writes_overlays(tmp_path):
    from mnc_tpu_torch.tools import demo

    buf = io.StringIO()
    with _port_cfg_restored(), contextlib.redirect_stdout(buf):
        assert demo.main(["--synthetic", "--device", "cpu", "--out", str(tmp_path),
                          "--stages", "3", "--set", *SMALL_CFG, "STATIC.CANVAS", "[96, 128]",
                          "STATIC.TEST_PRE_NMS_TOP_N", "256",
                          "STATIC.TEST_POST_NMS_TOP_N", "64"]) == 0
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == [f"synthetic_{i}.png" for i in range(4)]
    assert (tmp_path / "synthetic_0.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    png = demo._png_bytes(np.zeros((2, 3, 3), np.uint8))
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and b"IEND" in png
