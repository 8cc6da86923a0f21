"""The ResNet family of the port against the JAX package, module by module:
``FrozenBN``, ``Bottleneck`` (v1 and v1.5), ``ResNetTrunk`` (its output and
the gradients of its stages, frozen or not, against ``jax.grad``) and the
per-RoI conv5 head (with the gradient to the mask logits through mask
pooling), on bridged weights at the small sizes of ``tests/test_resnet.py``
(ResNet-50, 64×96 canvas, warp 4, narrow fc); then the weight bridges on
ResNet trees and train states, the torchvision import, and ``from_cfg`` on
the COCO configuration.  The cascade as a whole is in
``tests/test_torch_resnet_slice.py``.

Every JAX tree gets random FrozenBN leaves (``randomize_bn``) before it is
bridged: at init every ``bn3`` scale is 0 ("zero-gamma"), so each block
would be its shortcut and its convolutions would never reach the output.

Tolerances (f32 on both sides; XLA and oneDNN sum in different orders):
FrozenBN bit for bit in bf16 (product and sum each rounded, in the same
order) and 1e-6 relative in f32; block, trunk and head outputs within 1e-5
of the output's max; gradients within 1e-4 of each leaf's max (no ReLU
unit of these sizes lies within rounding of 0: measured); the torchvision
import within 1e-6.
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.models.resnet import Bottleneck as JBottleneck
from mnc_tpu.models.resnet import FrozenBN as JFrozenBN
from mnc_tpu.models.resnet import ResNetTrunk as JResNetTrunk
from mnc_tpu.utils.checkpoint import load_npz as j_load_npz
from mnc_tpu.utils.weights import load_resnet_torchvision as j_load_resnet_torchvision
from mnc_tpu_torch import config as C
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.models.resnet import Bottleneck, FrozenBN, ResNetTrunk
from mnc_tpu_torch.train.loop import TrainState, make_train_step
from mnc_tpu_torch.train.optim import make_optimizer
from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict, load_train_state,
                                            save_train_state, state_dict_from_jax)
from mnc_tpu_torch.utils.weights import fold_bn, load_resnet_torchvision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO = os.path.join(REPO, "experiments", "cfgs", "mnc_coco_resnet101.yml")
SMALL = dict(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
             warp_hw=4, trunk="resnet50", fc_dim=32, mask_fc_dim=16, pre_nms_top_n=32,
             post_nms_top_n=8, rpn_min_size=4.0)


@functools.lru_cache(maxsize=None)
def jax_mnc(roi_conv5: bool):
    """The small f32 JAX MNC and its init params (compiled once per head)."""
    jm = JMNC(arch=JArch(compute_dtype=jnp.float32, roi_conv5=roi_conv5, **SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((64, 96, 3), jnp.float32),
                              jnp.array([64.0, 96.0, 1.0]))
    return jm, {"params": params["params"]}


def randomize_bn(tree, rs):
    """A copy of a JAX tree with every FrozenBN leaf drawn anew: scales in
    [0.5, 1.5] and biases in [-0.3, 0.3], except that each bottleneck's
    ``bn3`` scale lies in [0.1, 0.3] and the stem's ``bn1`` scale is divided
    by 64, as folding the statistics of a trained network would make them.
    FrozenBN normalizes nothing, so with scales of ~1 everywhere the
    features of uint8 canvases would reach the hundreds, the proposals would
    degenerate and the class scores saturate."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "scale" in v:
            n = np.asarray(v["scale"]).shape
            lo, hi = (0.1, 0.3) if k == "bn3" else (0.5, 1.5)
            scale = rs.uniform(lo, hi, n) / (64.0 if k == "bn1" and "stage2_block0" in tree else 1.0)
            out[k] = {"scale": jnp.asarray(scale, jnp.float32),
                      "bias": jnp.asarray(rs.uniform(-0.3, 0.3, n), jnp.float32)}
        elif isinstance(v, dict):
            out[k] = randomize_bn(v, rs)
        else:
            out[k] = v
    return out


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_bn_matches_jax(dtype):
    rs = np.random.RandomState(0)
    x = (3 * rs.randn(2, 5, 7, 8)).astype(np.float32)
    jbn = JFrozenBN(8, jnp.dtype(dtype))
    params = randomize_bn({"params": jbn.init(jax.random.PRNGKey(0), x)["params"]}, rs)
    want = np.asarray(jbn.apply(params, jnp.asarray(x, dtype)).astype(jnp.float32))
    bn = FrozenBN(8, getattr(torch, dtype))
    bn.load_state_dict(state_dict_from_jax(params))
    got = _nhwc(bn(_nchw(x).to(getattr(torch, dtype))))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("stride_in_3x3,stride,project", [
    (False, 2, True), (True, 2, True), (False, 1, False), (True, 1, True)],
    ids=["v1-stride2-proj", "v1.5-stride2-proj", "identity", "v1.5-stride1-proj"])
def test_bottleneck_matches_jax(stride_in_3x3, stride, project):
    """Odd sizes at stride 2: the padding is k // 2 on both sides."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 11, 16).astype(np.float32)
    jblk = JBottleneck(4, stride, project, jnp.float32, stride_in_3x3)
    params = randomize_bn({"params": jblk.init(jax.random.PRNGKey(1), x)["params"]}, rs)
    want = np.asarray(jblk.apply(params, x))
    blk = Bottleneck(16, 4, stride, project, torch.float32, stride_in_3x3)
    blk.load_state_dict(state_dict_from_jax(params))
    _close(_nhwc(blk(_nchw(x))), want, 1e-5)


@pytest.mark.parametrize("frozen", [0, 2])
def test_trunk_output_and_gradients_match_jax(frozen):
    """ResNet-50's conv1-conv4 on two 64×96 images: the features, and the
    gradient of a fixed projection of them.  Frozen stages (the stem and
    stage 2 at 2) get no gradient in the port and zeros in JAX."""
    rs = np.random.RandomState(2)
    x = (50 * rs.randn(2, 64, 96, 3)).astype(np.float32)
    jt = JResNetTrunk(50, jnp.float32, frozen_stages=frozen)
    params = randomize_bn({"params": jt.init(jax.random.PRNGKey(2), x)["params"]}, rs)
    proj = rs.randn(2, 4, 6, 1024).astype(np.float32)
    want = np.asarray(jt.apply(params, x))
    jgrad = jax.grad(lambda p: jnp.sum(jt.apply(p, x) * proj))(params)
    trunk = ResNetTrunk(50, torch.float32, frozen_stages=frozen)
    trunk.load_state_dict(state_dict_from_jax(params))
    trunk.requires_grad_(True)
    out = trunk(torch.from_numpy(x))
    _close(out.detach().numpy(), want, 1e-5, "features")
    (out * torch.from_numpy(proj)).sum().backward()
    got = {n: p.grad for n, p in trunk.named_parameters()}
    frozen_names = {n for n, g in got.items() if g is None}
    want_frozen = {n for n in got if frozen >= 1 and n.startswith(("conv1.", "bn1."))
                   or frozen >= 2 and n.startswith("stage2_")}
    assert frozen_names == want_frozen
    for n, w in state_dict_from_jax(jgrad).items():
        w = w.numpy()
        if n in frozen_names:
            assert not w.any(), n
        else:
            _close(got[n].numpy(), w, 1e-4, n)


@pytest.fixture(scope="module")
def conv5_model():
    """A small roi_conv5 MNC: the JAX module and params (random FrozenBN
    leaves) and the port's model on the same weights."""
    jm, params = jax_mnc(True)
    params = randomize_bn(params, np.random.RandomState(3))
    model = MNC(MNCArch(compute_dtype=torch.float32, roi_conv5=True, **SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jm, params, model


def test_conv_roi_head_and_mask_logit_gradient_match_jax(conv5_model):
    """``classify_stage`` (sigmoid → 9→4 resize → mask pooling → conv5 →
    mean → cls_score / bbox_pred) and the gradients of a fixed projection of
    its outputs to the RoI features and to the mask logits."""
    jm, params, model = conv5_model
    rs = np.random.RandomState(4)
    feat = rs.randn(6, 4, 4, 1024).astype(np.float32)
    logits = (2 * rs.randn(6, 9, 9)).astype(np.float32)
    r_cls, r_box = rs.randn(6, 4).astype(np.float32), rs.randn(6, 16).astype(np.float32)

    def jloss(f, m):
        cls, box = jm.apply(params, f, m, method=JMNC.classify_stage)
        return jnp.sum(cls * r_cls) + jnp.sum(box * r_box), (cls, box)

    (_, (jcls, jbox)), (jdf, jdm) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(feat, logits)
    f = torch.from_numpy(feat).requires_grad_()
    m = torch.from_numpy(logits).requires_grad_()
    cls, box = model.classify_stage(f, m, train=True, keep_masks=None)
    ((cls * torch.from_numpy(r_cls)).sum() + (box * torch.from_numpy(r_box)).sum()).backward()
    assert cls.dtype == box.dtype == torch.float32
    _close(cls.detach().numpy(), jcls, 1e-5, "cls")
    _close(box.detach().numpy(), jbox, 1e-5, "bbox")
    _close(f.grad.numpy(), jdf, 1e-4, "d features")
    _close(m.grad.numpy(), jdm, 1e-4, "d mask logits")
    assert np.abs(np.asarray(jdm)).max() > 0


def test_init_follows_the_flax_initializers():
    """Same parameter names and shapes as the JAX tree; FrozenBN scales are
    ones, zeros on every bn3; FrozenBN and fc biases are zeros."""
    want = state_dict_from_jax(jax_mnc(True)[1])
    got = MNC(MNCArch(compute_dtype=torch.float32, roi_conv5=True, **SMALL), device="cpu",
              seed=5).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    n_scale = 0
    for k, v in got.items():
        if k.endswith((".scale", ".bias")):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
            n_scale += k.endswith(".scale")
    assert n_scale == 1 + 3 * (3 + 4 + 6 + 3) + 4  # stem, 3 per block, 4 projections
    assert not got["trunk.stage4_block5.bn3.scale"].any()
    assert got["trunk.stage4_block5.bn2.scale"].eq(1).all()
    w = got["trunk.stage3_block1.conv2.weight"]
    assert abs(w.std().item() - (1 / (128 * 9)) ** 0.5) < 0.1 * (1 / (128 * 9)) ** 0.5


def test_trunk_and_head_choices_are_checked():
    with pytest.raises(ValueError, match="ROI_CONV5"):
        MNC(MNCArch(compute_dtype=torch.float32, **dict(SMALL, trunk="vgg16"),
                    roi_conv5=True), device="cpu")
    with pytest.raises(ValueError, match="unknown trunk"):
        MNC(MNCArch(compute_dtype=torch.float32, **dict(SMALL, trunk="resnet34")),
            device="cpu")


# --------------------------------------------------------------------------- #
# The bridges
# --------------------------------------------------------------------------- #


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("roi_conv5", [True, False], ids=["conv5-head", "fc-head"])
def test_resnet_tree_round_trips_through_the_bridges(roi_conv5):
    """JAX tree → state_dict (strict load: every key lands) → JAX tree: the
    same paths (bias-free convolutions, ``scale`` leaves, blocks nested in
    stages) and the same values."""
    params = randomize_bn(jax_mnc(roi_conv5)[1], np.random.RandomState(6))
    model = MNC(MNCArch(compute_dtype=torch.float32, roi_conv5=roi_conv5, **SMALL),
                device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    back, want = _leaves(jax_params_from_state_dict(model.state_dict())), _leaves(params)
    assert set(back) == set(want)
    assert "params/trunk/stage3_block2/bn2/scale" in want
    assert "params/trunk/conv1/kernel" in want and "params/trunk/conv1/bias" not in want
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_resnet_train_state_round_trip(tmp_path):
    """A ResNet train state after one step: the JAX package's load_npz reads
    its nested leaves, and it restores bit for bit."""
    from mnc_tpu_torch.data.synthetic import SyntheticShapes

    arch = MNCArch(compute_dtype=torch.float32, roi_conv5=True,
                   **dict(SMALL, canvas=(128, 160), anchor_scales=(2, 4, 8)))
    train_cfg = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                     RPN_FG_FRACTION=0.5, BATCH_SIZE=8, FG_FRACTION=0.25, FG_THRESH=0.5,
                     BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
    data = SyntheticShapes(canvas_hw=(128, 160), num_classes=4, max_gt=4, gt_mask_size=16,
                           n_range=(1, 2), seed=7)
    src = MNC(arch, device="cpu", seed=4, train=True)
    opt = make_optimizer(src, clip_gradients=10.0)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([2]).items()}
    saved, _ = make_train_step(src, opt, arch, train_cfg)(
        TrainState.create(src, opt), batch, torch.Generator().manual_seed(1))
    path = str(tmp_path / "state.npz")
    save_train_state(path, saved)
    tree = j_load_npz(path)
    want = jax_params_from_state_dict(src.state_dict())["params"]
    for leaf in (("trunk", "stage3_block1", "bn2", "scale"),
                 ("classify_head", "stage5_block0", "proj", "kernel"),
                 ("trunk", "conv1", "kernel")):
        a, b = tree["params"], want
        for k in leaf:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)
    model = MNC(arch, device="cpu", seed=5, train=True)
    state = TrainState.create(model, make_optimizer(model))
    load_train_state(path, state)
    assert state.step == 1 and state.opt.count == 1
    for (n, a), (_, b) in zip(model.state_dict().items(), src.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt.trace, saved.opt.trace):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# torchvision import
# --------------------------------------------------------------------------- #


def _torchvision_state_dict(depth_blocks=(3, 4, 6, 3), seed=8) -> dict:
    """A torchvision-format ResNet-50 state dict of seeded random tensors."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = (rs.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rs.uniform(-0.5, 0.5, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rs.uniform(-1, 1, c).astype(np.float32)
        sd[f"{name}.running_var"] = rs.uniform(0.2, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, (n, f) in enumerate(zip(depth_blocks, (64, 128, 256, 512))):
        for i in range(n):
            p = f"layer{layer + 1}.{i}"
            conv(f"{p}.conv1", f, cin if i == 0 else 4 * f, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 4 * f, f, 1)
            bn(f"{p}.bn3", 4 * f)
            if i == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
        cin = 4 * f
    return sd


@pytest.mark.parametrize("adapt_input,roi_conv5", [(True, True), (False, True), (True, False)],
                         ids=["adapt-conv5", "verbatim-conv5", "adapt-fc"])
def test_load_resnet_torchvision_matches_jax(adapt_input, roi_conv5, tmp_path):
    """One synthetic torchvision ResNet-50 state dict into both packages'
    models: the same weights within 1e-6 (BN folded, stem adapted or not,
    layer4 into the conv5 head when there is one; the fc head keeps its
    own).  The adapted case reads the state dict from a local file."""
    sd = _torchvision_state_dict()
    params = jax_mnc(roi_conv5)[1]
    want = _leaves(j_load_resnet_torchvision(params, sd, depth=50, adapt_input=adapt_input))
    model = MNC(MNCArch(compute_dtype=torch.float32, roi_conv5=roi_conv5, **SMALL),
                device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    if adapt_input:
        path = str(tmp_path / "resnet50.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        merged = load_resnet_torchvision(model.state_dict(), weights_path=path, depth=50)
    else:
        merged = load_resnet_torchvision(model.state_dict(), sd, depth=50, adapt_input=False)
    model.load_state_dict(merged)
    got = _leaves(jax_params_from_state_dict(model.state_dict()))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)
    s, b = fold_bn(sd["layer3.4.bn2.weight"], sd["layer3.4.bn2.bias"],
                   sd["layer3.4.bn2.running_mean"], sd["layer3.4.bn2.running_var"])
    np.testing.assert_array_equal(got["params/trunk/stage4_block4/bn2/scale"], s)
    np.testing.assert_array_equal(got["params/trunk/stage4_block4/bn2/bias"], b)


def test_fold_bn_matches_torch_batchnorm_in_eval():
    rs = np.random.RandomState(10)
    bn = torch.nn.BatchNorm2d(13).eval()
    with torch.no_grad():
        for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -1, 1), (bn.running_mean, -1, 1),
                          (bn.running_var, 0.5, 2.0)):
            t.copy_(torch.from_numpy(rs.uniform(lo, hi, 13).astype(np.float32)))
    x = rs.randn(2, 13, 5, 7).astype(np.float32)
    s, b = fold_bn(bn.weight.detach(), bn.bias.detach(), bn.running_mean, bn.running_var)
    np.testing.assert_allclose(x * s[:, None, None] + b[:, None, None],
                               bn(torch.from_numpy(x)).detach().numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# The COCO configuration
# --------------------------------------------------------------------------- #


@pytest.fixture
def coco_cfg():
    saved = C.cfg.clone()
    try:
        C.cfg_from_file(COCO)
        yield C.cfg
    finally:
        C.cfg.clear()
        C.cfg.update(saved)


@pytest.mark.parametrize("roi_conv5,train", [(True, False), (True, True), (False, False)],
                         ids=["serve-conv5", "train-conv5", "serve-fc"])
def test_coco_resnet101_from_cfg_builds(coco_cfg, roi_conv5, train):
    """The COCO yml (+ NET.ROI_CONV5) through ``from_cfg`` builds the
    ResNet-101 MNC at full width with the TEST and TRAIN working sets.  The conv5
    models are built on the CPU; the fc-head one (fc6 on 7·7·1024 inputs,
    300 M parameters) on the meta device, which checks its shapes without
    allocating them."""
    C.cfg_from_list(["NET.ROI_CONV5", str(roi_conv5)])
    with _no_cap_warning():
        arch = MNCArch.from_cfg(train=train)
    assert (arch.trunk, arch.num_classes, arch.roi_conv5, arch.resnet_stride_in_3x3,
            arch.trunk_frozen, arch.canvas) == ("resnet101", 81, roi_conv5, False, 2, (640, 1024))
    assert (arch.pre_nms_top_n, arch.post_nms_top_n) == ((12000, 2000) if train else (6000, 304))
    device = "cpu" if roi_conv5 else "meta"
    with torch.device(device):
        model = MNC(arch, device=device, seed=0, train=train)
    names = dict(model.named_parameters())
    assert len([n for n in names if n.startswith("trunk.stage4_block")]) == 23 * 9 + 3
    assert names["rpn_head.rpn_conv.weight"].shape == (512, 1024, 3, 3)
    assert names["mask_head.fc_mask.weight"].shape == (256, 14 * 14 * 1024)
    if roi_conv5:
        assert names["classify_head.stage5_block2.conv3.weight"].shape == (2048, 512, 1, 1)
        assert names["classify_head.bbox_pred.weight"].shape == (4 * 81, 2048)
        assert "classify_head.fc6.weight" not in names
    else:
        assert names["classify_head.fc6.weight"].shape == (4096, 7 * 7 * 1024)
    want_dtype = torch.float32 if train else torch.bfloat16
    assert all(p.dtype == want_dtype for p in names.values())
    assert all(p.requires_grad == train for p in names.values())


class _no_cap_warning:
    """The COCO yml's working sets fit their STATIC budgets: no CAPPED warning."""

    def __enter__(self):
        import warnings

        self._w = warnings.catch_warnings(record=True)
        self.caught = self._w.__enter__()
        warnings.simplefilter("always")

    def __exit__(self, *exc):
        self._w.__exit__(*exc)
        assert not [w for w in self.caught if "CAPPED" in str(w.message)]


@pytest.mark.parametrize("trunk", ["vgg16", "resnet101"])
def test_int8_is_still_refused(coco_cfg, trunk):
    C.cfg_from_list(["NET.TRUNK", trunk, "TEST.INT8", "True"])
    with pytest.raises(NotImplementedError, match="TEST.INT8"):
        MNCArch.from_cfg()
    assert MNCArch.from_cfg(train=True).trunk == trunk  # training never runs int8
