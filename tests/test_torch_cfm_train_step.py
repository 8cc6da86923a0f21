"""One CFM train step of the port (``mnc_tpu_torch/models/cfm.py``
``cfm_loss`` / ``make_cfm_train_step``) against the JAX package's
``cfm_loss`` and its solver, on bridged weights, at the architecture of
``tests/test_cfm.py`` (in float64 on both sides, for the reason
``tests/test_torch_train_step.py`` gives), for a batch of two images; and
the port's CFM training over many steps (``tests/test_cfm.py``'s learning
test, and the parameters that take no gradient).

The port gets JAX's own uniform draws (the keys ``cfm_loss`` and
``cfm_targets`` split off) and both sides get the same dropout keep-masks
(flax's ``Dropout`` replaced by a multiply with the next mask of a list,
inside the fixture only).  JAX's batch step vmaps the one-image loss and
takes the mean, which is what the mean of the per-image losses and
gradients is.

Tolerances (those of ``tests/test_torch_train_step.py``): every loss within
1e-6 relative, every gradient leaf within 1e-4 of that leaf's max, the
parameters after the step within 1e-6 absolute, sampled RoIs and labels
identical; the RPN's and the mask head's parameters bit-equal to what
decay alone makes of them.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.cfm import cfm_loss as j_cfm_loss
from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.train import targets as JT
from mnc_tpu.train.optim import make_optimizer as j_make_optimizer
from mnc_tpu_torch.models import cfm
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.train import targets as T
from mnc_tpu_torch.train.loop import CfmDraws, TrainState, draw_cfm_randoms
from mnc_tpu_torch.train.optim import make_optimizer
from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_resnet import _leaves
from tests.test_torch_train_step import MASKS, _fixed_dropout
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

ARCH_KW = dict(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
               warp_hw=4, n_stages=3, fc_dim=32, mask_fc_dim=16, pre_nms_top_n=32,
               post_nms_top_n=8, rpn_min_size=4.0)
TRAIN_CFG = dict(BATCH_SIZE=16, FG_FRACTION=0.25, FG_THRESH=0.5, BG_THRESH_HI=0.5,
                 BG_THRESH_LO=0.0)


def _t(x):
    return torch.tensor(np.asarray(x))


def cfm_batch(seed, n_images=1):
    """``tests/test_cfm.py``'s learning batch: two gt instances, their
    jittered boxes and two off-object boxes as the segments (full masks);
    with ``seed`` > 0 further images get their own jitter and image."""
    out = []
    for i in range(n_images):
        rs = np.random.RandomState(seed + i)
        gt_boxes = np.array([[8.0, 8.0, 39.0, 39.0], [50.0, 20.0, 89.0, 55.0]], np.float32)
        out.append({
            "image": rs.randn(64, 96, 3).astype(np.float32),
            "im_info": np.array([64.0, 96.0, 1.0], np.float32),
            "gt_boxes": gt_boxes, "gt_classes": np.array([1, 2], np.int32),
            "gt_valid": np.ones(2, bool), "gt_masks": np.ones((2, 9, 9), np.float32),
            "seg_boxes": np.concatenate([
                gt_boxes + rs.uniform(-2, 2, (2, 4)).astype(np.float32),
                np.array([[0.0, 45.0, 20.0, 63.0], [70.0, 0.0, 95.0, 15.0]], np.float32)]),
            "seg_masks": np.ones((4, 9, 9), np.float32), "seg_valid": np.ones(4, bool)})
    return {k: np.stack([e[k] for e in out]) for k in out[0]}


class Case:
    """Both packages' losses, gradients, sampled targets and stepped
    parameters for a batch of two images, in float64."""

    def __init__(self):
        jarch = JArch(compute_dtype=jnp.float64, **ARCH_KW)
        arch = MNCArch(compute_dtype=torch.float64, **ARCH_KW)
        jmodel = JMNC(arch=jarch)
        batch = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
                 for k, v in cfm_batch(0, 2).items()}
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["image"][0]),
                                      jnp.asarray(batch["im_info"][0]))
        keys = jax.random.split(jax.random.PRNGKey(42), 2)
        keep = np.random.RandomState(3).uniform(size=(2, 2, 16, 32)) < 0.5  # (fc6/7, B, R, D)
        pool = T.cfm_pool_size(4, 2, 16)

        @jax.jit
        def loss_and_grad(p, ex, key, masks):
            MASKS[:] = list(masks)  # consumed while this traces
            out = jax.value_and_grad(j_cfm_loss, has_aux=True)(p, jmodel, ex, key, jarch,
                                                               TRAIN_CFG)
            tgt = JT.cfm_targets(ex["seg_boxes"], ex["seg_masks"], ex["seg_valid"],
                                 ex["gt_boxes"], ex["gt_classes"], ex["gt_valid"],
                                 ex["gt_masks"], jax.random.split(key)[0], roi_batch=16,
                                 fg_fraction=0.25, bbox_means=jarch.bbox_means,
                                 bbox_stds=jarch.bbox_stds)
            return out, tgt

        self.j_losses, self.j_tgt, grads = [], [], []
        for i in range(2):
            ex = {k: jnp.asarray(v[i]) for k, v in batch.items()}
            ((_, losses), g), tgt = loss_and_grad(params, ex, keys[i],
                                                  [jnp.asarray(keep[m, i]) for m in range(2)])
            self.j_losses.append({k: float(v) for k, v in losses.items()})
            self.j_tgt.append(tgt)
            grads.append(g)
        self.j_grads = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
        self.j_mean = {k: float(np.mean([l[k] for l in self.j_losses]))
                       for k in self.j_losses[0]}
        tx = j_make_optimizer(params)
        updates, _ = tx.update(self.j_grads, tx.init(params), params)
        self.j_params = jax.tree.map(lambda p, u: p + u, params, updates)

        # ---- the port, on the same weights and the same draws
        self.model = MNC(arch, device="cpu", seed=0, train=True)
        self.model.load_state_dict(state_dict_from_jax(params))
        self.model.double()
        pairs = []
        for k in keys:
            k_fg, k_bg = jax.random.split(jax.random.split(k)[0])
            pairs.append((_t(jax.random.uniform(k_fg, (pool,))),
                          _t(jax.random.uniform(k_bg, (pool,)))))
        draws = CfmDraws(tuple(torch.stack(x) for x in zip(*pairs)),
                         (_t(keep[0]), _t(keep[1])))
        tbatch = {k: _t(v) for k, v in batch.items()}
        self.picked = []
        orig = T.cfm_targets

        def spy(*a, **kw):
            out = orig(*a, **kw)
            self.picked.append(out)
            return out

        T.cfm_targets = spy
        try:
            opt = make_optimizer(self.model)
            total, losses = cfm.cfm_loss(self.model, tbatch, draws, arch, TRAIN_CFG)
            total.backward()
            self.losses = {k: float(v.detach()) for k, v in losses.items()}
            self.grads = jax_params_from_state_dict(
                {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in self.model.named_parameters()})
            self.no_grad = sorted(n for n, p in self.model.named_parameters() if p.grad is None)
            self.model.zero_grad(set_to_none=True)
            self.state = TrainState.create(self.model, opt)
            _, self.metrics = cfm.make_cfm_train_step(self.model, opt, arch, TRAIN_CFG)(
                self.state, tbatch, draws)
        finally:
            T.cfm_targets = orig


@pytest.fixture(scope="module")
def case():
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(nn.Dropout, "__call__", _fixed_dropout)
        yield Case()


def test_losses_match(case):
    assert set(case.losses) == set(case.j_mean) == {"cfm_cls", "cfm_bbox", "total"}
    for k, want in case.j_mean.items():
        assert np.isfinite(want) and want > 0
        np.testing.assert_allclose(case.losses[k], want, rtol=1e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(float(case.metrics[k]), want, rtol=1e-6, atol=1e-8)


def test_sampled_rois_and_labels_identical(case):
    assert len(case.picked) == 4  # two images, in the loss and in the step
    for got, want in zip(case.picked[:2], case.j_tgt):
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        assert (np.asarray(want.labels) > 0).any() and (np.asarray(want.labels) == -1).any()
        np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
        np.testing.assert_array_equal(got.seg_masks.numpy(), np.asarray(want.seg_masks))
        np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                                   rtol=0, atol=1e-5)


def test_gradient_leaves_match(case):
    want, got = _leaves(case.j_grads["params"]), _leaves(case.grads["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=name)
    # the RPN, the mask head and the frozen blocks 1-2 take no gradient
    assert all(n.startswith(("rpn_head.", "mask_head.", "trunk.conv1_", "trunk.conv2_"))
               for n in case.no_grad)
    assert {n for n in case.no_grad if n.startswith(("rpn_head.", "mask_head."))} == {
        n for n, _ in case.model.named_parameters() if n.startswith(("rpn_head.", "mask_head."))}
    assert np.abs(want["classify_head/fc6/kernel"]).max() > 0
    assert np.abs(want["trunk/conv5_3/kernel"]).max() > 0


def test_parameters_after_one_step_match(case):
    got = _leaves(jax_params_from_state_dict(case.model.state_dict())["params"])
    want = _leaves(case.j_params["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6, err_msg=name)
    assert case.state.step == 1 and case.state.opt.count == 1


NO_GRAD = ("rpn_head.", "mask_head.")


def _train(weight_decay, steps, lr=0.01):
    arch = MNCArch(compute_dtype=torch.float32, **ARCH_KW)
    model = MNC(arch, device="cpu", seed=0, train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, base_lr=lr, weight_decay=weight_decay)
    step = cfm.make_cfm_train_step(model, opt, arch, TRAIN_CFG)
    state = TrainState.create(model, opt)
    batch = {k: _t(v[0]) for k, v in cfm_batch(0).items()}  # one image, no batch axis
    gen = torch.Generator().manual_seed(1)
    totals = [float(step(state, batch, gen)[1]["total"]) for _ in range(steps)]
    return model, opt, before, totals


def test_cfm_train_step_learns_and_leaves_mask_head_alone():
    """``tests/test_cfm.py::test_cfm_train_step_learns_and_leaves_mask_head_alone``
    on the port: 40 steps without weight decay (so that a zero gradient
    shows as bit-equality), the loss falls below 0.7 of its first value,
    the mask head and the RPN stay bit-equal, the classify head and the
    trunk move."""
    model, _, before, totals = _train(0.0, 40)
    assert totals[-1] < 0.7 * totals[0], (totals[0], totals[-1])
    after = dict(model.named_parameters())
    mask_keys = [n for n in before if n.startswith(NO_GRAD)]
    assert any(n.startswith("mask_head.") for n in mask_keys)
    for n in mask_keys:
        assert torch.equal(before[n], after[n]), n
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    assert any(n.startswith("classify_head.") for n in moved)
    assert any(n.startswith("trunk.conv") for n in moved)


def test_parameters_without_gradient_move_by_decay_alone():
    """With weight decay on, each RPN and mask-head kernel follows the
    solver's recurrence for a zero gradient (t ← wd·w + m·t, w ← w − lr·t),
    bit for bit, and their biases stay; JAX's optax chain does the same."""
    model, opt, before, _ = _train(0.0005, 5)
    for n, p in model.named_parameters():
        if not n.startswith(NO_GRAD):
            continue
        w, t = before[n].clone(), torch.zeros_like(before[n])
        for _ in range(5):
            if not n.endswith("bias"):
                t.mul_(opt.momentum).add_(torch.zeros_like(w).add(w, alpha=opt.weight_decay))
            else:
                t.mul_(opt.momentum).add_(torch.zeros_like(w) * 2.0)
            w.add_(t, alpha=-0.01)
        assert torch.equal(p.detach(), w), n
        assert n.endswith("bias") or not torch.equal(p.detach(), before[n]), n


def test_draw_cfm_randoms_shapes():
    arch = MNCArch(compute_dtype=torch.float32, **ARCH_KW)
    d = draw_cfm_randoms(torch.Generator().manual_seed(0), arch, TRAIN_CFG, 2, 5, 3)
    assert [tuple(x.shape) for x in d.roi] == [(2, 16), (2, 16)]
    assert [tuple(x.shape) for x in d.drop] == [(2, 16, 32), (2, 16, 32)]
    assert d.drop[0].dtype == torch.bool
    d = draw_cfm_randoms(torch.Generator().manual_seed(0), arch, TRAIN_CFG, 1, 64, 32)
    assert d.roi[0].shape == (1, T.cfm_pool_size(64, 32, 16)) == (1, 96)
