"""The host API of the port against the JAX package (which resizes with
``cv2``): the cv2-exact resize, ``prep_im_for_blob`` over many image sizes,
the mask resizes and unmold, bit packing, ``_pick_canvas`` with buckets, and
``detect`` / ``detect_many`` (ragged last chunk, portrait variant, packed,
``host_paste``) end to end on a small f32 model with the same params.

Tolerances.  The uint8 resize and ``prep_im_for_blob(u8=True)`` are
bit-equal to cv2; the float path within 2e-5 of it (the float canvas within
0.02 is what the port promises); 0/1 and soft single-channel masks
bit-equal.  Detections: selections (valid, classes, the picked canvas)
identical, boxes ≤1e-3 px, scores ≤1e-5, soft masks ≤1e-4; full-resolution
masks differ on < 1e-3 of the pixels (none here).  Since the resize is
bit-equal, ``detect`` parity holds on resized images as well as at scale 1,
and every case runs both sides end to end.
"""

import contextlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu import config as jconfig
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.pipeline import inference as jinf
from mnc_tpu.utils import blob as jblob
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline import inference as pinf
from mnc_tpu_torch.utils import blob
from mnc_tpu_torch.utils.checkpoint import load_npz, state_dict_from_jax
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

SMALL = dict(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=3, fc_dim=32, mask_fc_dim=16, pre_nms_top_n=32,
             post_nms_top_n=8, rpn_min_size=2.0)
POST = dict(dets_per_class=4, max_per_image=6, vote_top_k=8)


@contextlib.contextmanager
def both_cfgs(**test_keys):
    """TEST.* keys set in both packages' cfg, restored afterwards."""
    saved = [(c, {k: c.TEST[k] for k in test_keys}) for c in (jconfig.cfg, pconfig.cfg)]
    try:
        for c, _ in saved:
            for k, v in test_keys.items():
                c.TEST[k] = v
        yield
    finally:
        for c, old in saved:
            for k, v in old.items():
                c.TEST[k] = v


# --------------------------------------------------------------------------- #
# the resize against cv2
# --------------------------------------------------------------------------- #

U8_CASES = [(333, 500, 600 / 333), (375, 500, 1.6), (500, 375, 1.6), (480, 640, 1.25),
            (427, 640, 600 / 427), (100, 37, 0.7), (64, 48, 3.3), (123, 45, 7.7),
            (1000, 800, 0.5), (999, 801, 0.5), (375, 500, 0.5), (7, 9, 0.5),
            (77, 1201, 0.31), (640, 480, 1.0), (17, 1100, 1000 / 1100)]


@pytest.mark.parametrize("h,w,s", U8_CASES)
def test_resize_u8_is_bit_equal_to_cv2(h, w, s):
    im = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = cv2.resize(im, None, fx=s, fy=s, interpolation=cv2.INTER_LINEAR)
    got = blob.resize_linear(torch.from_numpy(im), scale=s).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,s", U8_CASES[:8])
def test_resize_float_image_agrees_with_cv2(h, w, s):
    im = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.float32) - 120.0
    want = cv2.resize(im, None, fx=s, fy=s, interpolation=cv2.INTER_LINEAR)
    got = blob.resize_linear(torch.from_numpy(im), scale=s).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("src,dst", [((21, 21), (42, 42)), ((30, 40), (61, 83)),
                                     ((64, 96), (128, 192)), ((50, 70), (37, 51)),
                                     ((13, 17), (100, 77)), ((21, 21), (5, 1)),
                                     ((600, 800), (450, 600))])
def test_resize_masks_are_bit_equal_to_cv2(src, dst):
    """0/1 masks (where ties at 0.5 decide pixels) and soft masks."""
    rs = np.random.RandomState(src[0] * dst[1])
    for m in ((rs.rand(*src) > 0.5).astype(np.float32), rs.rand(*src).astype(np.float32)):
        want = cv2.resize(m, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(dst)
        got = blob.resize_linear(torch.from_numpy(m), out_hw=dst).numpy()
        np.testing.assert_array_equal(got, want)
    masks = (rs.rand(3, *src) > 0.5)
    got = pinf._resize_mask_to(torch.from_numpy(masks), dst).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], jinf._resize_mask_to(masks[k], dst))


PREP_SIZES = [(333, 500), (500, 333), (375, 500), (500, 375), (480, 640), (640, 480),
              (427, 640), (640, 427), (600, 1000), (1000, 600), (1200, 2048),
              (1280, 2048), (2048, 1280), (64, 48), (17, 1100), (1100, 17), (640, 1024),
              (320, 512), (256, 320), (719, 1279), (1200, 1600), (1601, 1200), (90, 160)]


@pytest.mark.parametrize("u8", [True, False])
def test_prep_im_for_blob_matches_jax(u8):
    """>= 20 sizes, both orientations, down- and upscales, exact 2x
    downscales (1200x1600, and 1601x1200 with an odd edge) and scale 1
    (640x1024, 320x512 at SCALES 320); landscape and portrait canvases."""
    rs = np.random.RandomState(11)
    n_equal = n_total = 0
    scales = set()
    for h, w in PREP_SIZES:
        im = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        canvas = (640, 1024) if w >= h else (1024, 640)
        kw = dict(target_size=320, max_size=1024) if (h, w) == (320, 512) else {}
        want, winfo = jblob.prep_im_for_blob(im, canvas_hw=canvas, u8=u8, **kw)
        got, ginfo = blob.prep_im_for_blob(im, canvas_hw=canvas, u8=u8, **kw)
        np.testing.assert_array_equal(ginfo, winfo)
        scales.add(float(ginfo[2]))
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if u8:
            np.testing.assert_array_equal(got, want, err_msg=str((h, w)))
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=0.02, err_msg=str((h, w)))
            n_equal += int((got == want).sum())
            n_total += got.size
    assert {1.0, 0.5} <= scales and min(scales) < 0.5 < 1.0 < max(scales)
    if not u8:  # the float path is within 2e-5, mostly bit-equal
        assert n_equal / n_total > 0.99


def test_prep_scale_one_is_exact_and_uploads_the_original():
    im = np.random.RandomState(4).randint(0, 255, size=(48, 64, 3), dtype=np.uint8)
    cf, info_f = blob.prep_im_for_blob(im, target_size=48, max_size=64, canvas_hw=(64, 80))
    cu, info_u = blob.prep_im_for_blob(torch.from_numpy(im), target_size=48, max_size=64,
                                       canvas_hw=(64, 80), u8=True)
    assert cu.dtype == torch.uint8 and info_f[2] == 1.0
    np.testing.assert_array_equal(info_f, info_u)
    np.testing.assert_array_equal(cu[:48, :64].numpy(), im)
    means = np.asarray(pconfig.cfg.PIXEL_MEANS, np.float32).reshape(1, 1, 3)
    np.testing.assert_allclose((cu.numpy().astype(np.float32) - means), cf.numpy(), atol=0.5)
    np.testing.assert_array_equal(blob.im_list_to_blob([cf, cf]).numpy(),
                                  jblob.im_list_to_blob([cf.numpy(), cf.numpy()]))


@pytest.mark.parametrize("src,dst", [((100, 80), (28, 28)), ((50, 30), (28, 28)),
                                     ((20, 30), (28, 28)), ((28, 28), (28, 28)),
                                     ((33, 97), (13, 29)), ((10, 12), (28, 28))])
def test_resize_mask_area_matches_jax(src, dst):
    m = (np.random.RandomState(src[0]).rand(*src) > 0.4).astype(np.float32)
    np.testing.assert_allclose(blob.resize_mask_area(m, dst), jblob.resize_mask_area(m, dst),
                               rtol=0, atol=1e-6)


def test_pack_bits_is_numpys_packbits():
    m = np.random.RandomState(0).rand(3, 5, 37) > 0.5
    packed = pinf.pack_bits(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(m, axis=-1))
    out = pinf.unpack_canvas_masks({"canvas_masks": packed}, 37)["canvas_masks"]
    np.testing.assert_array_equal(out, m)


def test_unmold_masks_host_matches_jax():
    rs = np.random.RandomState(5)
    masks = rs.rand(6, 9, 9).astype(np.float32)
    boxes = np.array([[3.2, 4.7, 40.1, 30.5], [-5, -5, 20, 20], [50, 10, 95.4, 59.9],
                      [10, 10, 10.2, 10.4], [30, 2, 31, 50], [0, 0, 99, 59]], np.float32)
    valid = np.array([True, True, True, True, False, True])
    np.testing.assert_array_equal(pinf.unmold_masks_host(masks, boxes, valid, (60, 100)),
                                  jinf.unmold_masks_host(masks, boxes, valid, (60, 100)))


# --------------------------------------------------------------------------- #
# the pipeline against the JAX package's
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, **SMALL))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((64, 96, 3), jnp.float32),
                     jnp.array([64.0, 96.0, 1.0]))
    path = str(tmp_path_factory.mktemp("npz") / "params.npz")
    save_npz(path, params, {"bbox_pred_normalized": True})
    model = MNC(MNCArch(compute_dtype=torch.float32, **SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(load_npz(path)[0]))
    return (jinf.MNCPipeline(jm, params, jinf.PostCfg(paste_dtype="f32", **POST)),
            pinf.MNCPipeline(model, pinf.PostCfg(**POST)))


def _images():
    rs = np.random.RandomState(2)
    return [  # 3 landscape + 2 portrait: two canvas groups, both with a short tail
        (rs.rand(60, 120, 3) * 255).astype(np.uint8),
        (rs.rand(50, 100, 3) * 255).astype(np.uint8),
        (rs.rand(120, 60, 3) * 255).astype(np.uint8),
        (rs.rand(48, 96, 3) * 255).astype(np.uint8),  # scale 1 (SCALES 48)
        (rs.rand(100, 55, 3) * 255).astype(np.uint8),
    ]


def assert_dets_match(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].any()
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)
    if "full_masks" in want:
        assert got["full_masks"].dtype == want["full_masks"].dtype == np.uint8
        assert got["full_masks"].shape == want["full_masks"].shape
        assert (got["full_masks"] != want["full_masks"]).mean() < 1e-3


@pytest.fixture(scope="module")
def streams(pipes):
    """detect_many (batch 2) of the mixed images, packed and not, and with
    host_paste, from both packages; one detect per orientation."""
    jpipe, ppipe = pipes
    imgs = _images()
    out = {}
    with both_cfgs(SCALES=(48,), MAX_SIZE=96):
        for name, kw in (("packed", dict(packed=True)), ("unpacked", dict(packed=False)),
                         ("host_paste", dict(host_paste=True))):
            out[name] = (jpipe.detect_many(imgs, batch_size=2, **kw),
                         ppipe.detect_many(imgs, batch_size=2, **kw))
        out["detect"] = ([jpipe.detect(imgs[i]) for i in (0, 2)],
                         [ppipe.detect(imgs[i]) for i in (0, 2)])
        out["variants"] = (sorted(jpipe._variants), sorted(ppipe._variants))
    return imgs, out


@pytest.mark.parametrize("mode", ["packed", "unpacked", "host_paste"])
def test_detect_many_matches_jax(streams, mode):
    imgs, out = streams
    want, got = out[mode]
    for im, g, w in zip(imgs, got, want):
        assert g["full_masks"].shape == (len(g["scores"]), *im.shape[:2])
        assert_dets_match(g, w)


def test_detect_matches_jax_and_the_stream(streams):
    imgs, out = streams
    (want, got), many = out["detect"], out["packed"][1]
    for g, w, m in zip(got, want, (many[0], many[2])):
        assert_dets_match(g, w)
        assert_dets_match(g, m)  # one image alone = that image in the stream
    # the portrait image ran on the transposed canvas, in both packages
    assert out["variants"][0] == out["variants"][1] == [(64, 96), (96, 64)]


def test_host_paste_agrees_with_device_paste(streams):
    """Boxes, scores and soft masks are the pasting route's; full masks
    differ only by the resampling route (IoU > 0.5 where both are big)."""
    _, out = streams
    agree = 0
    for host, dev in zip(out["host_paste"][1], out["packed"][1]):
        np.testing.assert_array_equal(host["valid"], dev["valid"])
        np.testing.assert_allclose(host["boxes"], dev["boxes"], rtol=1e-5)
        np.testing.assert_allclose(host["masks"], dev["masks"], rtol=1e-5)
        assert not host["full_masks"][~host["valid"]].any()
        for k in np.flatnonzero(host["valid"]):
            a, b = host["full_masks"][k] > 0, dev["full_masks"][k] > 0
            if a.sum() > 20 and b.sum() > 20:
                assert (a & b).sum() / max((a | b).sum(), 1) > 0.5
                agree += 1
    assert agree > 0


def test_in_flight_window_is_pure_scheduling(pipes, streams):
    imgs, out = streams
    with both_cfgs(SCALES=(48,), MAX_SIZE=96):
        timings = {}
        serial = pipes[1].detect_many(imgs, batch_size=2, packed=True, max_in_flight=1,
                                      timings=timings)
    assert set(timings) == {"prep", "device", "transfer", "finalize"}
    for got, want in zip(serial, out["packed"][1]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_canvas_buckets_pick_smallest_fitting_as_jax(pipes):
    jpipe, ppipe = pipes
    cases = [(60, 80), (60, 160), (80, 60), (30, 40), (200, 90), (48, 96)]
    with both_cfgs(SCALES=(32,), MAX_SIZE=96, CANVAS_BUCKETS=((32, 48), (48, 80))):
        for h, w in cases:
            for auto in (True, False):
                assert ppipe._pick_canvas(h, w, auto) == jpipe._pick_canvas(h, w, auto)
        assert ppipe._pick_canvas(30, 40, True) == (32, 48)
        assert ppipe.prewarm(batch_size=2) == [(64, 96), (32, 48), (48, 80), (96, 64),
                                               (48, 32), (80, 48)]
    with both_cfgs(CANVAS_BUCKETS=((50, 96),)):
        with pytest.raises(ValueError, match="multiples"):
            ppipe._pick_canvas(60, 80, True)


def test_canvas_variants_share_the_parameters(pipes):
    ppipe = pipes[1]
    v = ppipe._variant((96, 64))
    assert v is ppipe._variant((96, 64)) and v.arch.canvas == (96, 64)
    assert ppipe.model.arch.canvas == (64, 96)
    for (n, p), (n2, p2) in zip(ppipe.model.named_parameters(), v.named_parameters()):
        assert n == n2 and p is p2
    assert v.anchors.shape == ppipe.model.anchors.shape
    assert not torch.equal(v.anchors, ppipe.model.anchors)


def test_packed_canvas_paths_match_jax(pipes):
    """detect_canvas[_batch]_packed: the packed canvas masks of both packages
    unpack to the same bool canvases."""
    jpipe, ppipe = pipes
    rs = np.random.RandomState(3)
    canvases = rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    infos = np.array([[64.0, 96.0, 1.0], [50.0, 90.0, 1.0]], np.float32)
    want = jax.device_get(jpipe.detect_canvas_batch_packed(jnp.asarray(canvases),
                                                           jnp.asarray(infos)))
    got = {k: v.numpy() for k, v in ppipe.detect_canvas_batch_packed(canvases, infos).items()}
    assert got["canvas_masks"].shape == want["canvas_masks"].shape == (2, 6, 64, 12)
    one = {k: v.numpy() for k, v in ppipe.detect_canvas_packed(canvases[1], infos[1]).items()}
    for key in ("valid", "classes", "canvas_masks"):
        np.testing.assert_array_equal(one[key], got[key][1])
    np.testing.assert_allclose(one["boxes"], got["boxes"][1], rtol=0, atol=1e-3)
    g = pinf.unpack_canvas_masks(got, 96)["canvas_masks"]
    w = jinf.unpack_canvas_masks(want, 96)["canvas_masks"]
    assert (g != w).mean() < 1e-3
