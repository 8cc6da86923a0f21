"""CFM (``mnc_tpu_torch/models/cfm.py``) on the ResNet trunk, with the
per-RoI conv5 head (``NET.ROI_CONV5``) and with the fc head, and CFM under
``TEST.INT8``, against the JAX package (``mnc_tpu/models/cfm.py``).

ResNet: the small ResNet-50 architecture of ``tests/test_torch_resnet.py``
(64×96 canvas, warp 4, mask 9) on one JAX init per head whose FrozenBN
leaves are drawn at random (``randomize_bn``: at init every block would be
its shortcut), bridged into the port.  ``cfm_apply`` in f32 on 16
segments: cls_prob within 1e-5, refined boxes within 1e-3 px.  One
``cfm_loss`` step in float64 on both sides (the reason is given in
``tests/test_torch_train_step.py``), as ``tests/test_torch_cfm_train_step.py``
holds the VGG-16 one: JAX's own uniform draws, the same dropout keep-masks
for the fc head (flax's ``Dropout`` replaced inside the fixture only) and
none for the conv5 head, which has no dropout; sampled RoIs and labels
identical, losses within 1e-6 relative, every gradient leaf within 1e-4 of
that leaf's max.  Under x64 ``jax.image.resize`` weighs in float64, so the
port's classify-stage mask resize takes JAX's float64 weights there (its
own are the f32 weights JAX computes without x64).

int8: the small int8 VGG-16 of ``tests/test_torch_quant.py`` (f32 and
bf16), against JAX evaluated op by op (outside ``jit``, whose rewrites the
quant tests describe): the int8 trunk's features bit for bit, and the
int8 fc6 / fc7 outputs on the same RoI features bit for bit in bf16 (in
f32 within 1e-6: the mask resize before fc6 sums in another order, which
moves fc6's activation scale by an ulp; ``tests/test_torch_quant.py``
holds the int8 dense layer bit for bit on equal inputs); then
``cfm_detect``: valid flags, classes and canvas masks identical, scores and
boxes bit for bit in bf16, and in f32 within 1e-6 and 1e-4 px (the float
RoI warp sums in another order, within 1e-6), soft masks within 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models import cfm as jcfm
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
from mnc_tpu.train import targets as JT
from mnc_tpu_torch.models import cfm
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.pipeline.inference import PostCfg
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.train.loop import CfmDraws, draw_cfm_randoms
from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_cfm_train_step import TRAIN_CFG, cfm_batch
from tests.test_torch_resnet import SMALL, _leaves, jax_mnc, randomize_bn
from tests.test_torch_train_step import MASKS, _fixed_dropout
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

HEADS = {"conv5": True, "fc": False}
INFO = np.array([64.0, 96.0, 1.0], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def jax_params(roi_conv5):
    """The head's JAX init with random FrozenBN leaves (seeded)."""
    return randomize_bn(jax_mnc(roi_conv5)[1], np.random.RandomState(11))


def _segments(seed, n=16, n_valid=12, s=13):
    rs = np.random.RandomState(seed)
    xy = np.stack([rs.uniform(0, 40, n), rs.uniform(0, 30, n)], 1)
    boxes = np.concatenate([xy, np.minimum(xy + rs.uniform(10, 50, (n, 2)), [95, 63])],
                           1).astype(np.float32)
    masks = rs.uniform(size=(n, s, s)).astype(np.float32)
    masks[::2] = masks[::2] > 0.5
    valid = np.arange(n) < n_valid
    boxes[~valid], masks[~valid] = 0.0, 0.0
    return rs.randn(64, 96, 3).astype(np.float32) * 40, boxes, masks, valid


@pytest.mark.parametrize("head", list(HEADS))
def test_cfm_apply_matches_jax_on_resnet(head):
    roi_conv5 = HEADS[head]
    params = jax_params(roi_conv5)
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, roi_conv5=roi_conv5, **SMALL))
    model = MNC(MNCArch(compute_dtype=torch.float32, roi_conv5=roi_conv5, **SMALL),
                device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    image, boxes, masks, valid = _segments(2)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, *a: jcfm.cfm_apply(jm, p, *a))(params, image, INFO, boxes, masks, valid))
    got = cfm.cfm_apply(model, *map(_t, (image, INFO, boxes, masks, valid)))
    np.testing.assert_allclose(got["cls_prob"].numpy(), want["cls_prob"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-3)
    assert want["cls_prob"][valid].max(-1).min() < 0.99  # not saturated: the test can see
    np.testing.assert_array_equal(got["valid"].numpy(), valid)


def test_draw_cfm_randoms_draws_no_dropout_for_the_conv5_head():
    """JAX's ``cfm_loss`` hands the conv5 head a dropout key that no module
    uses; the port draws no keep-masks there, the fc head's (R, fc_dim)."""
    gen = torch.Generator().manual_seed(0)
    conv5 = MNCArch(compute_dtype=torch.float32, roi_conv5=True, **SMALL)
    d = draw_cfm_randoms(gen, conv5, TRAIN_CFG, 2, 4, 2)
    pool = T.cfm_pool_size(4, 2, TRAIN_CFG["BATCH_SIZE"])
    assert d.drop is None and [tuple(x.shape) for x in d.roi] == [(2, pool), (2, pool)]
    fc = MNCArch(compute_dtype=torch.float32, roi_conv5=False, **SMALL)
    d = draw_cfm_randoms(torch.Generator().manual_seed(0), fc, TRAIN_CFG, 2, 4, 2)
    assert [tuple(x.shape) for x in d.drop] == [(2, 16, SMALL["fc_dim"])] * 2


class LossCase:
    """Both packages' CFM loss, gradients and sampled targets on one image,
    in float64."""

    def __init__(self, roi_conv5):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        jax_params(roi_conv5))
        jarch = JArch(compute_dtype=jnp.float64, roi_conv5=roi_conv5, **SMALL)
        arch = MNCArch(compute_dtype=torch.float64, roi_conv5=roi_conv5, **SMALL)
        jmodel = JMNC(arch=jarch)
        batch = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
                 for k, v in cfm_batch(0, 1).items()}
        ex = {k: jnp.asarray(v[0]) for k, v in batch.items()}
        key = jax.random.PRNGKey(42)
        keep = np.random.RandomState(3).uniform(size=(2, 16, SMALL["fc_dim"])) < 0.5
        MASKS[:] = [jnp.asarray(k) for k in keep]  # consumed by the fc head while tracing
        (_, losses), grads = jax.jit(jax.value_and_grad(
            lambda p: jcfm.cfm_loss(p, jmodel, ex, key, jarch, TRAIN_CFG), has_aux=True))(params)
        self.j_losses = {k: float(v) for k, v in losses.items()}
        self.j_grads = grads
        self.j_tgt = JT.cfm_targets(ex["seg_boxes"], ex["seg_masks"], ex["seg_valid"],
                                    ex["gt_boxes"], ex["gt_classes"], ex["gt_valid"],
                                    ex["gt_masks"], jax.random.split(key)[0], roi_batch=16,
                                    fg_fraction=0.25, bbox_means=jarch.bbox_means,
                                    bbox_stds=jarch.bbox_stds)

        model = MNC(arch, device="cpu", seed=0, train=True)
        model.load_state_dict(state_dict_from_jax(params))
        model.double()
        # under x64 jax.image.resize weighs in float64 (the port's matrix holds
        # the f32 weights that JAX computes without x64): the classify stage's
        # mask resize gets JAX's float64 weights here, or a max-pool window
        # whose two largest values lie within 1e-7 is decided otherwise
        eye = jnp.eye(SMALL["mask_size"], dtype=jnp.float64)
        model.resize_mat = _t(jax.vmap(lambda e: jax.image.resize(
            e, (SMALL["warp_hw"],), "linear"))(eye)).T.contiguous()
        pool = T.cfm_pool_size(4, 2, 16)
        k_fg, k_bg = jax.random.split(jax.random.split(key)[0])
        roi = (_t(jax.random.uniform(k_fg, (pool,)))[None],
               _t(jax.random.uniform(k_bg, (pool,)))[None])
        drop = None if roi_conv5 else (_t(keep[0])[None], _t(keep[1])[None])
        self.picked = []
        orig = T.cfm_targets

        def spy(*a, **kw):
            out = orig(*a, **kw)
            self.picked.append(out)
            return out

        T.cfm_targets = spy
        try:
            total, losses = cfm.cfm_loss(model, {k: _t(v) for k, v in batch.items()},
                                         CfmDraws(roi, drop), arch, TRAIN_CFG)
            total.backward()
        finally:
            T.cfm_targets = orig
        self.losses = {k: float(v.detach()) for k, v in losses.items()}
        self.grads = jax_params_from_state_dict(
            {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()})


@pytest.fixture(scope="module", params=list(HEADS))
def loss_case(request):
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(nn.Dropout, "__call__", _fixed_dropout)
        yield request.param, LossCase(HEADS[request.param])


def test_cfm_loss_and_gradients_match_jax_on_resnet(loss_case):
    head, case = loss_case
    assert set(case.losses) == set(case.j_losses) == {"cfm_cls", "cfm_bbox", "total"}
    for k, want in case.j_losses.items():
        assert np.isfinite(want) and want > 0
        np.testing.assert_allclose(case.losses[k], want, rtol=1e-6, atol=1e-8, err_msg=k)
    (got_t,) = case.picked
    np.testing.assert_array_equal(got_t.labels[0].numpy() if got_t.labels.dim() > 1
                                  else got_t.labels.numpy(), np.asarray(case.j_tgt.labels))
    np.testing.assert_array_equal(got_t.rois.numpy(), np.asarray(case.j_tgt.rois))
    want, got = _leaves(case.j_grads["params"]), _leaves(case.grads["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=name)
    cls = "classify_head/stage5_block0/conv1/kernel" if head == "conv5" else \
        "classify_head/fc6/kernel"
    assert np.abs(want[cls]).max() > 0
    assert np.abs(want["trunk/stage4_block0/conv2/kernel"]).max() > 0
    assert not any(np.abs(w).max() > 0 for n, w in want.items()
                   if n.startswith(("rpn_head/", "mask_head/")))


# --------------------------------------------------------------------------- #
# CFM under TEST.INT8
# --------------------------------------------------------------------------- #

INT8 = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
            warp_hw=4, n_stages=5, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=64,
            post_nms_top_n=16, rpn_min_size=4.0)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
POST = dict(dets_per_class=4, max_per_image=6, vote_top_k=8, score_thresh=0.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cfm_detect_int8_matches_jax_op_by_op(dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JMNC(arch=JArch(compute_dtype=jdt, int8_inference=True, **INT8))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((96, 128, 3), jnp.float32),
                              jnp.array([96.0, 128.0, 1.0]))
    model = MNC(MNCArch(compute_dtype=tdt, int8_inference=True, **INT8), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))  # strict: every key lands
    rs = np.random.RandomState(4)
    image = rs.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    info = np.array([96.0, 128.0, 1.0], np.float32)
    xy = np.stack([rs.uniform(0, 70, 24), rs.uniform(0, 50, 24)], 1)
    boxes = np.concatenate([xy, np.minimum(xy + rs.uniform(12, 50, (24, 2)), [127, 95])],
                           1).astype(np.float32)
    masks = (rs.uniform(size=(24, 9, 9)) > 0.4).astype(np.float32)
    valid = np.arange(24) < 20

    # JAX op by op: the int8 trunk, the warp, and the classify stage with its
    # int8 fc6 / fc7 outputs captured
    feat = jm.apply(params, jnp.asarray(image), method=JMNC.features)
    roi = jm.apply(params, feat, jnp.asarray(boxes), method=JMNC.warp)
    pseudo = jcfm.mask_pseudo_logits(jnp.asarray(masks), INT8["mask_size"])
    _, inter = jm.apply(params, roi, pseudo, method=JMNC.classify_stage,
                        mutable=["intermediates"],
                        capture_intermediates=lambda m, _: m.name in ("fc6", "fc7"))
    acts = {}
    hooks = [getattr(model.classify_head, n).register_forward_hook(
        lambda m, a, o, n=n: acts.__setitem__(n, o)) for n in ("fc6", "fc7")]
    f32 = lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor) else x,  # noqa: E731
                               np.float32)
    with torch.inference_mode():
        pfeat = model.features(torch.from_numpy(image)[None])
        # the classify stage on JAX's own RoI features: the int8 layers alone
        model.classify_stage(torch.from_numpy(np.array(roi.astype(jnp.float32))).to(tdt),
                             cfm.mask_pseudo_logits(torch.from_numpy(masks),
                                                    INT8["mask_size"]))
    for h in hooks:
        h.remove()
    np.testing.assert_array_equal(f32(pfeat), f32(feat).reshape(f32(pfeat).shape))
    for n in ("fc6", "fc7"):
        want_act = f32(inter["intermediates"]["classify_head"][n]["__call__"][0])
        if dtype == "bfloat16":
            np.testing.assert_array_equal(f32(acts[n]), want_act, err_msg=n)
        else:  # the f32 mask resize before fc6 sums in another order: an ulp of its scale
            np.testing.assert_allclose(f32(acts[n]), want_act, rtol=1e-6, atol=1e-6,
                                       err_msg=n)

    want = jax.tree_util.tree_map(np.asarray, jcfm.cfm_detect(
        jm, params, jnp.asarray(image), jnp.asarray(info), jnp.asarray(boxes),
        jnp.asarray(masks), jnp.asarray(valid), JPostCfg(paste_dtype="f32", **POST)))
    got = cfm.cfm_detect(model, image, info, boxes, masks, valid, PostCfg(**POST))
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() > 2
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    np.testing.assert_array_equal(got["canvas_masks"].numpy(), want["canvas_masks"])
    if dtype == "bfloat16":  # both sides round every layer to bf16: no sum order shows
        for k in ("scores", "boxes"):
            np.testing.assert_array_equal(f32(got[k]), f32(want[k]), err_msg=k)
    else:  # the float RoI warp sums in another order (within 1e-6)
        np.testing.assert_allclose(f32(got["scores"]), f32(want["scores"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(f32(got["boxes"]), f32(want["boxes"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f32(got["masks"]), f32(want["masks"]), rtol=0, atol=1e-5)
