"""The training slice as a whole: one optimizer step of the port against the
JAX package, on bridged weights, numpy-seeded images and shared draws, at the
small architecture of ``tests/test_train.py``, 3- and 5-stage, one image
and a batch of two.  (The 3-stage cases run the same tests from
``tests/test_torch_train_step_3stage.py``, and a ResNet-50 with the per-RoI
conv5 head from ``tests/test_torch_train_step_resnet.py``, so that the slow
compilations of the JAX gradient can proceed on several workers.)

Both sides compute in float64 here (JAX under a local ``jax.enable_x64``).
In float32 the two packages' sums differ in their last bits, and of the
~1.6 million ReLU units of this small trunk one or two have a pre-activation
so close to 0 that they end up on different sides; each such unit moves one
output channel's gradient by up to 9% of the leaf's max (measured), which
would force a tolerance too loose to see a real fault.  In float64 no unit
switches, and the comparison is tight.  A float32 case holds the losses.

The port gets JAX's own uniform draws (the keys ``mnc_loss`` splits off) and
both sides get the same dropout keep-masks: flax's ``Dropout.__call__`` is
replaced, inside the fixture only, by a multiply with the next mask of a
list.  The batch case averages the per-image losses and gradients of the
JAX ``mnc_loss``, which is what its vmapped ``loss_for_batch`` computes.

Tolerances: every loss within 1e-5 relative (1e-6 in f64: the RoI warp
takes its boxes in f32 in the port); every gradient leaf within 1e-4 of that
leaf's max; parameters after the step within 1e-6 absolute; sampled RoIs
and labels identical.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.data.synthetic import SyntheticShapes as JSyntheticShapes
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch, propose_rois as j_propose_rois
from mnc_tpu.train import targets as JT
from mnc_tpu.train.loop import mnc_loss as j_mnc_loss
from mnc_tpu.train.optim import make_optimizer as j_make_optimizer
from mnc_tpu.utils.checkpoint import load_npz as j_load_npz
from mnc_tpu_torch.data.synthetic import SyntheticShapes
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.train.loop import StepDraws, TrainState, make_train_step, mnc_loss
from mnc_tpu_torch.train.optim import make_optimizer
from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict, load_train_state,
                                            save_train_state, state_dict_from_jax)
from tests.test_torch_resnet import _leaves, randomize_bn
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

SMALL = dict(canvas=(128, 160), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
             warp_hw=4, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=128, post_nms_top_n=32,
             rpn_min_size=4.0)
TRAIN_CFG = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                 RPN_FG_FRACTION=0.5, BATCH_SIZE=32, FG_FRACTION=0.25, FG_THRESH=0.5,
                 BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
DATA_KW = dict(canvas_hw=SMALL["canvas"], num_classes=4, max_gt=4, gt_mask_size=16,
               n_range=(1, 2), seed=7)
MASKS: list = []  # the keep-masks the patched flax Dropout consumes, in call order


def _fixed_dropout(self, inputs, deterministic=None, rng=None):
    det = nn.module.merge_param("deterministic", self.deterministic, deterministic)
    if det:
        return inputs
    return jnp.where(MASKS.pop(0), inputs / (1.0 - self.rate), 0.0)


def _t(x):
    return torch.tensor(np.asarray(x))


def _uniform_pair(key, n):
    k1, k2 = jax.random.split(key)
    return _t(jax.random.uniform(k1, (n,))), _t(jax.random.uniform(k2, (n,)))


_JITTED: dict = {}


def _jitted_loss_and_grad(jmodel, jarch):
    """One compiled value-and-grad of the JAX ``mnc_loss`` per architecture
    (compiling it is the slow part of this file)."""
    if jarch not in _JITTED:
        anchors = jnp.asarray(jarch.all_anchors())

        @jax.jit
        def fn(params, ex, key, masks):
            MASKS[:] = list(masks)  # consumed while this traces
            out = jax.value_and_grad(j_mnc_loss, has_aux=True)(
                params, jmodel, ex, key, jarch, anchors, TRAIN_CFG)
            return out, _j_sampled(params, jmodel, jarch, anchors, ex, key)

        _JITTED[jarch] = fn
    return _JITTED[jarch]


def _j_sampled(params, jmodel, jarch, anchors, ex, key):
    """The RoIs that the JAX ``mnc_loss`` samples, recomputed as it does."""
    feat = jmodel.apply(params, ex["image"], method=JMNC.features)
    rpn_cls, rpn_bbox = jmodel.apply(params, feat, method=JMNC.rpn)
    rois, valid, _ = j_propose_rois(rpn_cls, rpn_bbox, ex["im_info"], anchors, jarch)
    return JT.proposal_targets(rois, valid, ex["gt_boxes"], ex["gt_classes"], ex["gt_valid"],
                               ex["gt_masks"], jax.random.split(key, 4)[1], roi_batch=32,
                               fg_fraction=0.25, mask_size=9)


_J_RESULTS: dict = {}  # (JAX arch, image index) -> JAX losses, gradients, targets (f64)
_J_PARAMS: dict = {}  # JAX arch -> its init params


def _init_params(jmodel, jarch, batch):
    """``MNC.init`` with PRNGKey(0), compiled (an eager init of the f64
    cascade takes tens of seconds), once per architecture: the batch case
    and the single-image case share them."""
    if jarch not in _J_PARAMS:
        _J_PARAMS[jarch] = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                jnp.asarray(batch["image"][0]),
                                                jnp.asarray(batch["im_info"][0]))
    return _J_PARAMS[jarch]


def frozen_parameter_names(model: MNC) -> list:
    """What the trunk's frozen blocks (VGG) or stem and stages (ResNet)
    hold: the parameters that get no gradient."""
    a = model.arch
    if a.trunk == "vgg16":
        prefixes = tuple(f"trunk.conv{b + 1}_" for b in range(a.trunk_frozen))
    else:
        prefixes = (("trunk.conv1.", "trunk.bn1.") if a.trunk_frozen >= 1 else ()) + tuple(
            f"trunk.stage{s}_" for s in range(2, a.trunk_frozen + 1))
    return sorted(n for n, _ in model.named_parameters() if n.startswith(prefixes))


class Case:
    """Both packages' losses, gradients and stepped parameters for one
    (n_stages, image indices, architecture overrides) setting.  A ResNet's
    FrozenBN leaves are drawn at random (``randomize_bn``): at init every
    block is its shortcut."""

    def __init__(self, n_stages, indices, f64=True, arch_kw=None):
        b = len(indices)
        jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
        kw = dict(SMALL, n_stages=n_stages, **(arch_kw or {}))
        jarch = JArch(compute_dtype=jdt, **kw)
        arch = MNCArch(compute_dtype=tdt, **kw)
        jmodel = JMNC(arch=jarch)
        data = SyntheticShapes(**DATA_KW)
        batch = {k: (v.astype(np.float64) if f64 and v.dtype == np.float32 else v)
                 for k, v in data.batch(indices).items()}
        params = _init_params(jmodel, jarch, batch)
        if arch.trunk != "vgg16":
            params = randomize_bn({"params": params["params"]}, np.random.RandomState(12))
        anchors = jnp.asarray(jarch.all_anchors())
        # image i always gets key i and keep-masks i, in a batch or alone
        keys = jax.random.split(jax.random.PRNGKey(42), 2)[np.asarray(indices)]
        rs = np.random.RandomState(3)
        # fc6/fc7 of pass 1, then of pass 2
        keep = (rs.uniform(size=(4, 2, 32, 64)) < 0.5)[:, list(indices)]
        pool = T.proposal_pool_size(32, 4, 32)

        # ---- JAX: per-image loss and gradients, averaged over the images
        self.j_losses, self.j_tgt = [], []
        grads = []

        for i in range(b):
            ex = {k: jnp.asarray(v[i]) for k, v in batch.items()}
            masks = [jnp.asarray(keep[m, i]) for m in range(4)]
            if not f64:  # forward only, eagerly
                MASKS[:] = masks
                _, losses = j_mnc_loss(params, jmodel, ex, keys[i], jarch, anchors, TRAIN_CFG)
                res = (losses, jax.tree.map(jnp.zeros_like, params), None)
            elif (jarch, indices[i]) not in _J_RESULTS:
                # a single-image case reuses what the batch case computed
                ((_, losses), g), tgt = _jitted_loss_and_grad(jmodel, jarch)(
                    params, ex, keys[i], masks)
                _J_RESULTS[jarch, indices[i]] = (losses, g, tgt)
            losses, g, tgt = res if not f64 else _J_RESULTS[jarch, indices[i]]
            self.j_losses.append({k: float(v) for k, v in losses.items()})
            grads.append(g)
            self.j_tgt.append(tgt)
        self.j_grads = jax.tree.map(lambda *g: sum(g) / b, *grads)
        self.j_mean = {k: float(np.mean([l[k] for l in self.j_losses]))
                       for k in self.j_losses[0]}
        tx = j_make_optimizer(params)
        updates, _ = tx.update(self.j_grads, tx.init(params), params)
        self.j_params = jax.tree.map(lambda p, u: p + u, params, updates)

        # ---- the port, on the same weights and the same draws
        self.model = MNC(arch, device="cpu", seed=0, train=True)
        self.model.load_state_dict(state_dict_from_jax(params))
        if f64:
            self.model.double()
        splits = [jax.random.split(k, 4) for k in keys]
        k_anchors = arch.all_anchors().shape[0]
        stack = lambda pairs: tuple(torch.stack(x) for x in zip(*pairs))  # noqa: E731
        draws = StepDraws(
            stack([_uniform_pair(s[0], k_anchors) for s in splits]),
            stack([_uniform_pair(s[1], pool) for s in splits]),
            (_t(keep[0]), _t(keep[1])), (_t(keep[2]), _t(keep[3])))
        tbatch = {k: _t(v) for k, v in batch.items()}
        if b == 1:  # the single-image form: no batch axis
            tbatch = {k: v[0] for k, v in tbatch.items()}
        self.picked = []
        orig = T.proposal_targets

        def spy(*a, **kw):
            out = orig(*a, **kw)
            self.picked.append(out)
            return out

        T.proposal_targets = spy
        try:
            opt = make_optimizer(self.model)
            step = make_train_step(self.model, opt, arch, TRAIN_CFG)
            self.state = TrainState.create(self.model, opt)
            total, losses = mnc_loss(self.model, tbatch, draws, arch, self.model.anchors,
                                     TRAIN_CFG)
            total.backward()
            self.losses = {k: float(v.detach()) for k, v in losses.items()}
            self.grads = jax_params_from_state_dict(
                {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in self.model.named_parameters()})
            self.frozen = sorted(n for n, p in self.model.named_parameters() if p.grad is None)
            self.model.zero_grad(set_to_none=True)
            self.picked.clear()
            _, self.metrics = step(self.state, tbatch, draws)
        finally:
            T.proposal_targets = orig


def case_fixture(n_stages, **arch_kw):
    """A module-scoped ``case`` fixture over a batch of two and one image;
    ``arch_kw`` overrides fields of both packages' architectures."""

    @pytest.fixture(scope="module", params=[(0, 1), (0,)], ids=["batch2", "single"])
    def case(request):
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(nn.Dropout, "__call__", _fixed_dropout)
            yield Case(n_stages, request.param, arch_kw=arch_kw)

    return case


case = case_fixture(5)


def check_losses_match_in_float32():
    """The f32 configuration that training runs: all eight losses and the
    total of a 5-stage step, within 1e-5 relative.  (Run from the 3-stage
    file, to balance the two workers.)"""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", _fixed_dropout)
        c = Case(5, (1,), f64=False)
    assert len(c.losses) == 9
    for k, want in c.j_mean.items():
        np.testing.assert_allclose(c.losses[k], want, rtol=1e-5, atol=1e-7, err_msg=k)


def test_synthetic_data_is_the_same_in_both_packages():
    a, b = SyntheticShapes(**DATA_KW).batch([0, 3]), JSyntheticShapes(**DATA_KW).batch([0, 3])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_losses_match(case):
    names = {"rpn_cls", "rpn_bbox", "s23_mask", "s23_cls", "s23_bbox", "total"}
    if case.model.arch.n_stages == 5:
        names |= {"s45_mask", "s45_cls", "s45_bbox"}
    assert set(case.losses) == set(case.j_mean) == names
    for k, want in case.j_mean.items():
        assert np.isfinite(want)
        np.testing.assert_allclose(case.losses[k], want, rtol=1e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(float(case.metrics[k]), want, rtol=1e-6, atol=1e-8)


def test_sampled_rois_and_labels_identical(case):
    assert len(case.picked) == len(case.j_tgt)
    for got, want in zip(case.picked, case.j_tgt):
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        assert (np.asarray(want.labels) > 0).any()
        np.testing.assert_allclose(got.rois.detach().numpy(), np.asarray(want.rois), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(got.mask_targets.numpy(), np.asarray(want.mask_targets))


def test_gradient_leaves_match(case):
    want, got = _leaves(case.j_grads["params"]), _leaves(case.grads["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=name)
    # blocks 1-2 (VGG) or the stem and stage 2 (ResNet) are frozen: no
    # gradient in the port, zeros in JAX
    assert case.frozen == frozen_parameter_names(case.model)
    if case.model.arch.trunk == "vgg16":
        assert case.frozen == sorted(f"trunk.conv{b}_{i}.{k}" for b in (1, 2)
                                     for i in (1, 2) for k in ("weight", "bias"))
    else:
        assert len(case.frozen) == 3 + 3 * 9 + 3  # stem, stage 2's blocks, its projection
    assert np.abs(np.asarray(want["rpn_head/rpn_bbox_pred/kernel"])).max() > 0


def test_parameters_after_one_step_match(case):
    got = _leaves(jax_params_from_state_dict(case.model.state_dict())["params"])
    want = _leaves(case.j_params["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    assert case.state.step == 1 and case.state.opt.count == 1


def test_train_state_npz_round_trip(tmp_path):
    """The saved state (f32) restores bit for bit, and the JAX package's
    load_npz reads its parameters."""
    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    src = MNC(arch, device="cpu", seed=4, train=True)
    opt = make_optimizer(src)
    batch = {k: _t(v) for k, v in SyntheticShapes(**DATA_KW).batch([2]).items()}
    saved, _ = make_train_step(src, opt, arch, TRAIN_CFG)(
        TrainState.create(src, opt), batch, torch.Generator().manual_seed(1))
    path = str(tmp_path / "state.npz")
    save_train_state(path, saved)
    tree = j_load_npz(path)
    want = jax_params_from_state_dict(src.state_dict())["params"]
    np.testing.assert_array_equal(tree["params"]["classify_head"]["fc6"]["kernel"],
                                  want["classify_head"]["fc6"]["kernel"])
    model = MNC(arch, device="cpu", seed=5, train=True)
    state = TrainState.create(model, make_optimizer(model))
    load_train_state(path, state)
    assert state.step == 1 and state.opt.count == 1
    for (n, a), (_, b) in zip(model.state_dict().items(), src.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt.trace, saved.opt.trace):
        assert torch.equal(a, b)


def test_downstream_losses_reach_rpn_bbox_pred():
    """The cascade property on the port alone: the stage-2/3 losses (no RPN
    loss) give rpn_bbox_pred a gradient, through the RoI warp's gradient to
    the box coordinates."""
    from mnc_tpu_torch.train.loop import draw_step_randoms

    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    model = MNC(arch, device="cpu", seed=1, train=True)
    batch = {k: _t(v) for k, v in SyntheticShapes(**DATA_KW).batch([1]).items()}
    draws = draw_step_randoms(torch.Generator().manual_seed(3), arch, TRAIN_CFG, 1, 4)
    _, losses = mnc_loss(model, batch, draws, arch, model.anchors, TRAIN_CFG)
    (losses["s23_mask"] + losses["s23_cls"] + losses["s23_bbox"]).backward()
    assert model.rpn_head.rpn_bbox_pred.weight.grad.abs().max() > 0
    assert model.rpn_head.rpn_cls_score.weight.grad is None or \
        model.rpn_head.rpn_cls_score.weight.grad.abs().max() == 0


def test_step_with_empty_ground_truth_and_generator_draws():
    """An image with no instance trains (a pure-background step), with the
    draws made from a torch.Generator by the step itself."""
    arch = MNCArch(compute_dtype=torch.float32, **SMALL)
    model = MNC(arch, device="cpu", seed=2, train=True)
    ex = SyntheticShapes(**DATA_KW).example(0)
    for k in ("gt_valid", "gt_boxes", "gt_classes", "gt_masks"):
        ex[k] = np.zeros_like(ex[k])
    opt = make_optimizer(model)
    step = make_train_step(model, opt, arch, TRAIN_CFG)
    state, metrics = step(TrainState.create(model, opt), {k: _t(v) for k, v in ex.items()},
                          torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["s23_mask"]) == 0.0 and state.step == 1
