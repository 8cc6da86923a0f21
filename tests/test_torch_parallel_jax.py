"""The port's parallel slice against the JAX package's ``mnc_tpu/parallel``
(the DP train step on the 8-device CPU mesh, the height-sharded trunk,
the DP eval step's per-image semantics under ``TEST.INT8``), and the port's
DP eval against its one-image runner.  The ranks are gloo processes, as in
``tests/test_torch_parallel.py`` (whose helpers this file uses).

Tolerances: the DP step as ``tests/test_parallel.py:93-108`` holds the JAX
DP step to its single-device step — ``total`` within 1e-5 relative, every
metric within 1e-4 relative (1e-6 absolute), every parameter within 5e-4
relative (1e-6 absolute).  Height-sharded features within 1e-5 of the map's
max, against the port's ``model.features`` and against JAX's
``spatial_trunk_features``.  The int8 features of the DP eval step bit for
The int8 activation quantization as the DP eval step's runner bit for bit
against JAX's ``data_parallel_eval_step`` evaluated op by op (under ``jit``
XLA rewrites the quantization's division; see ``tests/test_torch_quant.py``);
the DP detections bit for bit against the one-image runner.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.data.synthetic import SyntheticShapes as JSyntheticShapes
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.parallel import (data_parallel_eval_step as j_dp_eval, data_parallel_train_step
                              as j_dp_train, make_mesh as j_make_mesh, replicate as j_replicate,
                              shard_batch as j_shard_batch)
from mnc_tpu.parallel.spatial import shard_image as j_shard_image
from mnc_tpu.parallel.spatial import spatial_trunk_features as j_spatial
from mnc_tpu.train.loop import TrainState as JTrainState
from mnc_tpu.train.optim import make_optimizer as j_make_optimizer
from mnc_tpu_torch.models.mnc import MNC
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_parallel import (ARCH_KW, TRAIN_CFG, _metrics, _params, arch,
                                       assert_metrics, assert_params, run_ranks)
from tests.test_torch_resnet import randomize_bn
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

JARCH = JArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
              warp_hw=4, n_stages=3, compute_dtype=jnp.float32, fc_dim=48, mask_fc_dim=24,
              pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0)
JDATA = JSyntheticShapes(canvas_hw=(96, 128), num_classes=4, max_gt=4, gt_mask_size=16,
                         n_range=(1, 2), seed=5)


def _sd_arrays(params, prefix="sd/") -> dict:
    return {f"{prefix}{k}": v.numpy() for k, v in state_dict_from_jax(params).items()}


def _mask_only(self, inputs, deterministic=None, rng=None):
    """flax's ``Dropout.__call__`` drawing its keep-mask as flax does, but
    sowing it and returning it (test-only patch)."""
    mask = jax.random.bernoulli(self.make_rng(self.rng_collection), p=1.0 - self.rate,
                                shape=inputs.shape)
    self.sow("intermediates", "keep", mask)
    return mask.astype(inputs.dtype)


def keep_masks(jm, params, key):
    """The two keep-masks (after fc6, after fc7) that ``classify_stage``'s
    dropout draws under ``rngs={"dropout": key}`` for R RoIs."""
    r, w, c = TRAIN_CFG["BATCH_SIZE"], JARCH.warp_hw, 512
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", _mask_only)
        _, inter = jm.apply(params, jnp.zeros((r, w, w, c)),
                            jnp.zeros((r, JARCH.mask_size, JARCH.mask_size)), True,
                            method=JMNC.classify_stage, rngs={"dropout": key},
                            mutable=["intermediates"])
    head = inter["intermediates"]["classify_head"]
    return tuple(np.asarray(head[f"Dropout_{i}"]["keep"][0]) for i in range(2))


def port_draws(jm, params, keys) -> dict:
    """The port's ``StepDraws`` of each image from its JAX key, as
    ``mnc_loss`` splits it: (anchor, roi, drop1, drop2) keys; the uniforms
    of ``_random_keep`` from each pair, flax's dropout masks."""
    k = JARCH.feat_hw[0] * JARCH.feat_hw[1] * JARCH.num_anchors
    pool = T.proposal_pool_size(JARCH.post_nms_top_n, 4, TRAIN_CFG["BATCH_SIZE"])
    fields = {f"{f}/{i}": [] for f in ("anchor", "roi", "drop1", "drop2") for i in range(2)}
    for key in keys:
        k_anchor, k_roi, k_drop1, k_drop2 = jax.random.split(key, 4)
        for name, kk, n in (("anchor", k_anchor, k), ("roi", k_roi, pool)):
            for i, sub in enumerate(jax.random.split(kk)):
                fields[f"{name}/{i}"].append(np.asarray(jax.random.uniform(sub, (n,))))
        for name, kk in (("drop1", k_drop1), ("drop2", k_drop2)):
            for i, m in enumerate(keep_masks(jm, params, kk)):
                fields[f"{name}/{i}"].append(m)
    return {f"draws/{k}": np.stack(v) for k, v in fields.items()}


@pytest.fixture(scope="module")
def jax_dp_step():
    """The JAX DP step on the 8-device mesh, 8 images, PRNGKey(7), as
    ``tests/test_parallel.py`` runs it (compiled once): params before, the
    step's params and metrics, the key."""
    jm = JMNC(arch=JARCH)
    ex = JDATA.example(0)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ex["image"]), jnp.asarray(ex["im_info"]))
    tx = j_make_optimizer(params)
    mesh = j_make_mesh()
    step = j_dp_train(jm, tx, JARCH, TRAIN_CFG, mesh, donate=False)
    batch = {k: jnp.asarray(v) for k, v in JDATA.batch(range(8)).items()}
    key = jax.random.PRNGKey(7)
    s1, m1 = step(j_replicate(JTrainState.create(params, tx), mesh),
                  j_shard_batch(batch, mesh), key)
    return jm, params, jax.device_get(s1.params), jax.device_get(m1), key


def test_dp_step_equals_jax(tmp_path, jax_dp_step):
    """2 ranks × 4 images on the JAX step's parameters, with the draws of
    its global key split (``jax.random.split(key, 8)``, image i's key
    split as ``mnc_loss`` splits it; flax's own dropout masks), against the
    JAX DP step over 8 CPU devices × 1 image."""
    jm, params, j_params, j_metrics, key = jax_dp_step
    arrays = {**_sd_arrays(params), **port_draws(jm, params, jax.random.split(key, 8)),
              **{f"batch/{k}": v for k, v in JDATA.batch(range(8)).items()}}
    spec = {"arch": ARCH_KW, "train_cfg": TRAIN_CFG}
    outs = run_ranks(tmp_path, "dp", 2, spec, arrays)
    assert_metrics(_metrics(outs[0]), {k: float(v) for k, v in j_metrics.items()}, "DP vs JAX")
    assert_params(_params(outs[0]), {k: v.numpy() for k, v in
                                     state_dict_from_jax(j_params).items()}, "DP vs JAX")


@pytest.fixture(scope="module")
def spatial_case():
    """The small VGG-16 and ResNet-50 v1 and v1.5 of the JAX package with
    the port's seeded parameters bridged (random FrozenBN leaves), and one
    64×96 image."""
    rs = np.random.RandomState(6)
    image = (60 * rs.randn(64, 96, 3)).astype(np.float32)
    cases = {}
    for name, trunk, v15 in (("vgg", "vgg16", False), ("resnet50", "resnet50", False),
                             ("resnet50_v15", "resnet50", True)):
        ja = JArch(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
                   warp_hw=4, trunk=trunk, fc_dim=32, mask_fc_dim=16, pre_nms_top_n=32,
                   post_nms_top_n=8, rpn_min_size=4.0, compute_dtype=jnp.float32,
                   resnet_stride_in_3x3=v15)
        jm = JMNC(arch=ja)
        port = MNC(arch(canvas=[64, 96], anchor_scales=[1, 2, 4], trunk=trunk, fc_dim=32,
                        mask_fc_dim=16, pre_nms_top_n=32, post_nms_top_n=8,
                        resnet_stride_in_3x3=v15), device="cpu", seed=1)
        params = randomize_bn(jax_params_from_state_dict(port.state_dict()), rs)
        cases[name] = (jm, params)
    return cases, image


def test_spatial_trunk_matches_features_and_jax(tmp_path, spatial_case):
    """2 ranks × 32 rows of a 64×96 image through VGG-16 and ResNet-50
    (v1 strides: the 1×1/s2 convolutions; v1.5: the 3×3/s2 ones; both: the
    7×7/s2/p3 stem, the 3×3/s2/p1 pool with its −inf edge): the gathered
    features against the port's
    ``model.features`` and against JAX's ``spatial_trunk_features`` on 2 CPU
    devices; a height that is not a multiple of 2·16 raises."""
    cases, image = spatial_case
    arrays, trunks = {"image": image}, {}
    for name, (jm, params) in cases.items():
        arrays.update(_sd_arrays(params, f"{name}/"))
        trunks[name] = dict(ARCH_KW, canvas=[64, 96], anchor_scales=[1, 2, 4],
                            trunk=jm.arch.trunk, fc_dim=32, mask_fc_dim=16,
                            pre_nms_top_n=32, post_nms_top_n=8,
                            resnet_stride_in_3x3=jm.arch.resnet_stride_in_3x3)
    outs = run_ranks(tmp_path, "spatial", 2, {"trunks": trunks}, arrays)
    mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
    for name, (jm, params) in cases.items():
        got = np.concatenate([o[f"feat/{name}"] for o in outs])
        assert [o[f"feat/{name}"].shape[0] for o in outs] == [2, 2]
        model = MNC(arch(**trunks[name]), device="cpu")
        model.load_state_dict(state_dict_from_jax(params))
        with torch.no_grad():
            want = model.features(torch.from_numpy(image)[None])[0].numpy()
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{name} vs features")
        jwant = np.asarray(jax.device_get(j_spatial(jm, mesh)(params,
                                                              j_shard_image(image, mesh))))
        np.testing.assert_allclose(got, jwant, rtol=0, atol=tol, err_msg=f"{name} vs JAX")
    assert "multiple of 2·16" in str(outs[0]["bad_h_error"])


def _eval_images():
    rs = np.random.RandomState(5)
    images = np.stack([rs.randint(lo, 256 - lo, size=(96, 128, 3))
                       for lo in (120, 0, 60, 10)]).astype(np.uint8)
    infos = np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0], [96.0, 100.0, 1.0],
                      [90.0, 128.0, 1.0]], np.float32)
    return images, infos


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_dp_eval_equals_the_one_image_runner(tmp_path, int8):
    """``data_parallel_eval_step`` over 2 ranks × 2 images of the small
    5-stage cascade: every output of every image (boxes, scores, classes,
    soft and bit-packed canvas masks) equals the one-image runner's on that
    image, in float and under ``TEST.INT8`` (where each image gets its own
    activation scales)."""
    images, infos = _eval_images()
    kw = dict(ARCH_KW, n_stages=5, int8_inference=int8)
    post = dict(dets_per_class=4, max_per_image=8)
    spec = {"arch": kw, "post": post, "model_seed": 2}
    outs = run_ranks(tmp_path, "eval", 2, spec, {"images": images, "infos": infos})
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    a = arch(n_stages=5, int8_inference=int8)
    pipe = MNCPipeline(MNC(a, device="cpu", seed=2), PostCfg(**post))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the same sums, bit for bit
    try:
        want = [pipe.detect_canvas_packed(torch.from_numpy(im), torch.from_numpy(info))
                for im, info in zip(images, infos)]
    finally:
        torch.set_num_threads(threads)
    for o in outs:
        assert {k[len("out/"):] for k in o} == set(want[0])
        for k in want[0]:
            np.testing.assert_array_equal(o[f"out/{k}"], np.stack([w[k].numpy() for w in want]),
                                          err_msg=k)


def test_dp_eval_int8_scales_per_image_as_jax(tmp_path):
    """Under ``TEST.INT8`` the DP eval step runs one image at a time, as the
    JAX package's step vmaps its one-image runner: with the activation
    quantization of an int8 layer as the runner (``quant_act`` against
    ``_quant_act``, one scale per tensor), 2 ranks × 2 float canvases of
    different range give JAX's ``data_parallel_eval_step`` (2 CPU
    devices, op by op) bit for bit: one scale per image, not the batch-wide
    one of ``apply_batch``."""
    from mnc_tpu.ops.quant import _quant_act

    rs = np.random.RandomState(8)
    images = np.stack([s * rs.randn(96, 128, 3) for s in (1.0, 30.0, 0.2, 7.0)])
    images = images.astype(np.float32)
    infos = np.tile(np.float32([96.0, 128.0, 1.0]), (4, 1))
    spec = {"arch": ARCH_KW, "runner": "quant_act"}
    outs = run_ranks(tmp_path, "eval", 2, spec, {"images": images, "infos": infos})
    mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
    with jax.disable_jit():
        fn = j_dp_eval(lambda p, im, info: dict(zip(("q", "scale"), _quant_act(im, False))),
                       mesh)
        want = {k: np.asarray(v) for k, v in fn({}, jnp.asarray(images),
                                                jnp.asarray(infos)).items()}
    batch_scale = np.float32(np.abs(images).max() / np.float32(127.0))
    for o in outs:
        np.testing.assert_array_equal(o["out/q"], want["q"])
        np.testing.assert_array_equal(o["out/scale"], want["scale"])
    assert len(set(want["scale"].ravel().tolist())) == 4
    assert not np.isclose(want["scale"][0], batch_scale)
