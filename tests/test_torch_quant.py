"""int8 inference (``TEST.INT8``) of the port against the JAX package's
``mnc_tpu/ops/quant.py`` and its int8 VGG-16 cascade, on the CPU (the plain
version of kernel E: float64 sums of the int8 values, exact), inputs from
numpy seeds.  The ResNet family, the audit tool and the entry points under
``TEST.INT8`` are in ``tests/test_torch_quant_slice.py``.

The reference is the JAX code evaluated op by op (flax ``apply`` outside
``jit``), whose arithmetic is the source's: under ``jit`` XLA:CPU rewrites
``max / 127.0`` into ``max * (1 / 127)`` (an ulp off the quotient for ~8% of
the weight channels) and contracts the dequantizing ``acc * s + bias`` into
an FMA, so the jitted JAX package differs from its own op-by-op evaluation
by up to one int8 step per layer; the port computes the IEEE quotient and a
separate multiply and add, as the source writes them and as kernel E does.

Bit for bit, f32 and bf16: ``quant_weight`` and ``quant_act`` (per tensor,
per row, an all-zero input at the 1e-8 floor), ``conv_int8`` against
``ConvInt8`` (VGG 3×3 with 3 and 64 input channels, the ResNet 7×7/s2/p3
stem, 1×1/s2, 3×3/s2/p1) and the ``ConvInt8`` module, ``dense_int8``
against ``DenseInt8``, the int8 VGG-16 trunk, and the batch-wide activation
scale of ``apply_batch`` (two canvases of different range: the JAX
package's batched features, which differ from the single image's).

The small int8 cascade (96×128, 4 classes, 5 stages as in
``tests/test_quant.py``; heads narrowed to fc 64 and mask fc 32, warp 4,
mask 9): NMS keeps, the RoIs and the classes identical, floats within
stated bounds (its float RPN and head layers sum in other orders in XLA and
oneDNN; a RoI feature that moves by an ulp can move one int8 value of the
per-RoI dense layers by one step).  Also ``from_cfg`` and the weight
carry-over of one npz with ``TEST.INT8`` on and off.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu import config as jconfig
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.ops import quant as JQ
from mnc_tpu.utils.checkpoint import save_npz
from mnc_tpu_torch import config as pconfig
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.ops import quant as Q
from mnc_tpu_torch.utils.checkpoint import load_import_weights, state_dict_from_jax
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
             post_nms_top_n=16, rpn_min_size=4.0)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _t(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()


# --------------------------------------------------------------------------- #
# quantizers and layers, bit for bit
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_quant_weight_matches_jax(kind):
    rs = np.random.RandomState(0)
    w = (rs.randn(3, 3, 16, 24) if kind == "conv" else rs.randn(40, 24)).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel: the scale floor
    jq, js = JQ._quant_weight(jnp.asarray(w))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if kind == "conv" else w.T.copy())
    tq, ts = Q.quant_weight(tw)
    want_q = np.asarray(jq).transpose(3, 0, 1, 2) if kind == "conv" else np.asarray(jq).T
    assert tq.dtype == torch.int8 and tq.is_contiguous()
    np.testing.assert_array_equal(tq.numpy(), want_q)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["tensor", "row", "zeros"])
def test_quant_act_matches_jax(dtype, case):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(1)
    x = (rs.randn(12, 96) * 5).astype(np.float32)
    if case == "zeros":
        x[:] = 0.0
    per_row = case == "row"
    jq, js = JQ._quant_act(jnp.asarray(x).astype(jdt), per_row)
    tq, ts = Q.quant_act(torch.from_numpy(x).to(tdt), per_row)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().reshape(np.shape(js)), np.asarray(js))


CONV_CASES = {  # name: (cin, k, stride, pad, bias)
    "vgg 3x3 cin3": (3, 3, 1, 1, True),
    "vgg 3x3 cin64": (64, 3, 1, 1, True),
    "resnet stem 7x7/s2/p3": (3, 7, 2, 3, False),
    "1x1/s2": (32, 1, 2, 0, False),
    "3x3/s2/p1": (32, 3, 2, 1, False),
}


def _jax_params(module, x, rs):
    """A module's init params, every leaf nudged by seeded noise (zero
    biases would not test the bias add)."""
    params = module.init(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rs.randn(*a.shape).astype(np.float32) * 0.02), params)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_int8_matches_jax(dtype, case):
    jdt, tdt = DTYPES[dtype]
    cin, k, s, p, bias = CONV_CASES[case]
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 13, 17, cin) * 3).astype(np.float32)
    jm = JQ.ConvInt8(24, (k, k), strides=(s, s), padding=[(p, p)] * 2, use_bias=bias,
                     compute_dtype=jdt)
    params = _jax_params(jm, jnp.asarray(x), rs)
    want = _np(jm.apply(params, jnp.asarray(x).astype(jdt)))
    w = torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(np.asarray(params["params"]["bias"])) if bias else None
    xt = torch.from_numpy(x).to(tdt)
    got = Q.conv_int8(xt, w, b, s, p)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(_t(got), want)
    # the module twin on the NCHW view the trunks hand it
    layer = Q.ConvInt8(cin, 24, k, s, p, bias=bias)
    layer.load_state_dict({"weight": w, **({"bias": b} if bias else {})})
    np.testing.assert_array_equal(_t(layer(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_int8_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(3)
    x = (rs.randn(20, 300) * 3).astype(np.float32)
    x[4] = 0.0  # a row at the scale floor
    jm = JQ.DenseInt8(40, compute_dtype=jdt)
    params = _jax_params(jm, jnp.asarray(x), rs)
    want = _np(jm.apply(params, jnp.asarray(x).astype(jdt)))
    w = torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy())
    b = torch.from_numpy(np.asarray(params["params"]["bias"]))
    got = Q.dense_int8(torch.from_numpy(x).to(tdt), w, b)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_t(got), want)
    layer = Q.DenseInt8(300, 40)
    layer.load_state_dict({"weight": w, "bias": b})
    np.testing.assert_array_equal(_t(layer(torch.from_numpy(x).to(tdt))), want)


def test_plain_version_is_exact_at_the_largest_sums():
    """All ±127 operands at K = 4608 (the widest K of the trunks, 127² · 4608
    = 7.4e7 in magnitude): the float64 sums equal integer sums, and the
    weight cache hands back the same bits until the weight changes."""
    rs = np.random.RandomState(4)
    xq = torch.from_numpy((rs.randint(0, 2, (1, 4, 5, 512)) * 254 - 127).astype(np.int8))
    wq = torch.from_numpy((rs.randint(0, 2, (6, 3, 3, 512)) * 254 - 127).astype(np.int8))
    wq[0] = 127
    xq[0, 0:3, 1:4] = 127  # output (1, 2) of channel 0 sums 4608 products of 127²
    one = torch.ones(6)
    got = Q.gemm_s8_plain(xq, wq, torch.tensor(1.0), one, None, 1, 1, torch.float32)
    xp = np.pad(xq.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    wl = wq.numpy().astype(np.int64)
    want = sum(np.einsum("hwc,oc->hwo", xp[0, i:i + 4, j:j + 5], wl[:, i, j])
               for i in range(3) for j in range(3))
    assert want[1, 2, 0] == 127 * 127 * 4608
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.float32))
    w = torch.randn(6, 512, 3, 3)
    first = Q.quantized_weight(w)
    assert Q.quantized_weight(w)[0] is first[0]
    with torch.no_grad():
        w.mul_(2.0)
    again = Q.quantized_weight(w)
    assert again[0] is not first[0]
    assert torch.equal(again[0], Q.quant_weight(w)[0])


# --------------------------------------------------------------------------- #
# the cascade
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def small_cascade(dtype: str):
    """The small int8 cascade in JAX (params from a jitted init) and the
    port's (the same params, bridged), two canvases of different range
    (image 0 spans 120..135, image 1 the whole 0..255), and JAX's outputs
    evaluated op by op: ``apply_batch`` with its trunk's output (the
    batched features) and the single-image features."""
    jdt, tdt = DTYPES[dtype]
    jm = JMNC(arch=JArch(compute_dtype=jdt, int8_inference=True, **SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                              jnp.array([96.0, 128.0, 1.0]))
    model = MNC(MNCArch(compute_dtype=tdt, int8_inference=True, **SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))  # strict: every key lands
    rs = np.random.RandomState(5)
    imgs = np.stack([rs.randint(120, 136, size=(96, 128, 3)),
                     rs.randint(0, 256, size=(96, 128, 3))]).astype(np.uint8)
    infos = np.array([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], np.float32)
    out, inter = jm.apply(params, jnp.asarray(imgs), jnp.asarray(infos),
                          method=JMNC.apply_batch, mutable=["intermediates"],
                          capture_intermediates=lambda m, _: m.name == "trunk")
    want = {"feat": _np(inter["intermediates"]["trunk"]["__call__"][0]),
            "feat0": _np(jm.apply(params, jnp.asarray(imgs[:1]), method=JMNC.features)),
            "out": {k: _np(v) for k, v in out.items()}}
    return model, imgs, infos, want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_wide_activation_scale_matches_jax(dtype):
    """The trunk's activation scales cover both canvases of the batch, as
    JAX's ``apply_batch`` takes them: the batched features equal JAX's bit
    for bit, and image 0's differ from its features alone (its batchmate's
    range sets every scale)."""
    model, imgs, _, want = small_cascade(dtype)
    with torch.inference_mode():
        feat = _t(model.features(torch.from_numpy(imgs)))
        feat0 = _t(model.features(torch.from_numpy(imgs[:1])))
    np.testing.assert_array_equal(feat, want["feat"])
    np.testing.assert_array_equal(feat0, want["feat0"])
    assert np.abs(feat[0] - feat0[0]).max() > 0.05 * np.abs(feat0[0]).max()


# (dtype, atol of cls_prob, of the boxes in px, of mask logits and bbox deltas
# relative to their max): in f32 one int8 step of a per-RoI dense layer moves a
# probability by up to ~1e-3; in bf16 both sides round the same layers to bf16,
# which hides the sum order, and a bound of one bf16 ulp (2^-7) is kept
CASCADE_TOL = {"float32": (1e-3, 1e-3, 2e-3), "bfloat16": (1e-3, 0.5, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_cascade_matches_jax(dtype):
    """``apply_batch`` of the int8 cascade against JAX's: NMS keeps and the
    top classes identical, the RoIs, the probabilities, the mask logits and
    the bbox deltas within ``CASCADE_TOL``."""
    tol_p, tol_box, tol_rel = CASCADE_TOL[dtype]
    model, imgs, infos, want = small_cascade(dtype)
    got = {k: _t(v) if v.is_floating_point() else v.numpy()
           for k, v in model.apply_batch(torch.from_numpy(imgs),
                                         torch.from_numpy(infos)).items()}
    w = want["out"]
    valid = w["roi_valid"]
    np.testing.assert_array_equal(got["roi_valid"], valid)
    assert valid.sum() > 8
    for key in ("rois", "stage3_rois"):
        np.testing.assert_allclose(got[key], w[key], rtol=0, atol=tol_box, err_msg=key)
    np.testing.assert_array_equal(got["cls_prob"].argmax(-1)[valid],
                                  w["cls_prob"].argmax(-1)[valid])
    for key in ("cls_prob", "stage3_cls_prob"):
        np.testing.assert_allclose(got[key], w[key], rtol=0, atol=tol_p, err_msg=key)
    for key in ("mask_logits", "bbox_pred", "stage3_mask_logits"):
        np.testing.assert_allclose(got[key], w[key], rtol=0,
                                   atol=tol_rel * max(1.0, np.abs(w[key]).max()), err_msg=key)


# --------------------------------------------------------------------------- #
# configuration and weights
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def restored_cfgs():
    saved = [(c, c.cfg.clone()) for c in (jconfig, pconfig)]
    try:
        yield
    finally:
        for c, cfg in saved:
            c.cfg.clear()
            c.cfg.update(cfg)


def test_from_cfg_int8_inference_only():
    with restored_cfgs():
        pconfig.cfg.TEST.INT8 = True
        assert MNCArch.from_cfg(train=False).int8_inference
        assert not MNCArch.from_cfg(train=True).int8_inference
        pconfig.cfg.TEST.INT8 = False
        assert not MNCArch.from_cfg(train=False).int8_inference


def test_npz_weights_carry_over_to_the_int8_model(tmp_path):
    """One npz of the JAX package loads into the bf16 serving model with
    ``int8_inference`` on and off: the same keys, strictly; the int8
    layers keep the f32 values (they are quantized from them), every other
    layer is held in bf16 in both; both run, and the int8 layers' weights
    are the same tensors in a ``for_canvas`` view."""
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, **SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((96, 128, 3), jnp.float32),
                              jnp.array([96.0, 128.0, 1.0]))
    npz = str(tmp_path / "params.npz")
    save_npz(npz, params, {"bbox_pred_normalized": True})
    models = {}
    for q in (False, True):
        arch = MNCArch(compute_dtype=torch.bfloat16, int8_inference=q, **SMALL)
        tree, arch = load_import_weights(None, npz, arch, None)
        models[q] = MNC(arch, device="cpu")
        models[q].load_state_dict(state_dict_from_jax(tree))
    p = params["params"]
    q_sd, f_sd = models[True].state_dict(), models[False].state_dict()
    assert list(q_sd) == list(f_sd)
    int8_layers = {"trunk.conv3_1": np.asarray(p["trunk"]["conv3_1"]["kernel"]).transpose(3, 2,
                                                                                            0, 1),
                   "classify_head.fc6": np.asarray(p["classify_head"]["fc6"]["kernel"]).T,
                   "mask_head.fc_mask": np.asarray(p["mask_head"]["fc_mask"]["kernel"]).T}
    for name, want in int8_layers.items():
        assert q_sd[f"{name}.weight"].dtype == torch.float32
        np.testing.assert_array_equal(q_sd[f"{name}.weight"].numpy(), want)
        assert f_sd[f"{name}.weight"].dtype == torch.bfloat16
        assert torch.equal(f_sd[f"{name}.weight"], torch.from_numpy(want).to(torch.bfloat16))
    for name in ("classify_head.cls_score.weight", "rpn_head.rpn_conv.weight",
                 "mask_head.mask_pred.bias"):
        assert q_sd[name].dtype == f_sd[name].dtype == torch.bfloat16
        assert torch.equal(q_sd[name], f_sd[name])
    img = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (1, 96, 128, 3))
                           .astype(np.uint8))
    info = torch.tensor([[96.0, 128.0, 1.0]])
    for m in models.values():
        out = m.apply_batch(img, info)
        assert torch.isfinite(out["cls_prob"]).all() and out["roi_valid"].any()
    view = models[True].for_canvas((128, 96))
    assert view.trunk.conv3_1.weight is models[True].trunk.conv3_1.weight
