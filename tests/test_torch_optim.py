"""The port's solver (``mnc_tpu_torch/train/optim.py``) against the JAX
package's optax chain, update by update, on numpy-seeded parameters and
gradients: frozen kernels (no gradient) still decay, biases get twice the
gradient and no decay, clipping comes first, the step schedule multiplies
after the momentum, and ``iter_size`` averages its micro-steps.

Tolerance: f32 on both sides, a handful of operations per update: rtol 1e-6,
atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mnc_tpu.train.optim import make_optimizer as j_make_optimizer
from mnc_tpu_torch.train.optim import CaffeSGD, step_lr
from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, state_dict_from_jax
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

SHAPES = {"trunk": {"conv1_1": ((3, 3, 3, 4), (4,)), "conv3_1": ((3, 3, 4, 6), (6,))},
          "classify_head": {"fc6": ((8, 5), (5,)), "bbox_pred": ((5, 8), (8,))}}
FROZEN = "trunk.conv1_1"


def _tree(rs, scale=1.0):
    return {"params": {m: {l: {"kernel": (rs.randn(*k) * scale).astype(np.float32),
                               "bias": (rs.randn(*b) * scale).astype(np.float32)}
                           for l, (k, b) in layers.items()} for m, layers in SHAPES.items()}}


def _run_both(n_calls, grad_scale=1.0, **kw):
    """Apply ``n_calls`` gradient calls to both solvers; yield the
    parameters of both after every call."""
    rs = np.random.RandomState(0)
    params = _tree(rs)
    tx = j_make_optimizer(params, **kw)
    opt_state = tx.init(params)
    named = [(n, torch.nn.Parameter(t)) for n, t in state_dict_from_jax(params).items()]
    opt = CaffeSGD(named, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    for _ in range(n_calls):
        grads = _tree(rs, grad_scale)
        for leaf in grads["params"]["trunk"]["conv1_1"]:  # a frozen block: zero gradient
            grads["params"]["trunk"]["conv1_1"][leaf][:] = 0
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = state_dict_from_jax(grads)
        for n, p in named:
            p.grad = None if n.startswith(FROZEN) else tg[n].clone()
        opt.step()
        yield jparams, jax_params_from_state_dict(dict(named)), opt


def _assert_trees_close(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, stepsize=1),  # two updates across a stepsize boundary
    dict(base_lr=0.05, momentum=0.5, weight_decay=0.01, gamma=0.5, stepsize=2),
    dict(base_lr=0.1, clip_gradients=1.0),
    dict(base_lr=0.1, caffe_bias_rules=False),
    dict(base_lr=0.1, weight_decay=0.0, momentum=0.0)])
def test_updates_match_optax(kw):
    for want, got, _ in _run_both(3, **kw):
        _assert_trees_close(got, want)


def test_clip_leaves_small_gradients_alone():
    for want, got, _ in _run_both(2, grad_scale=1e-3, base_lr=0.1, clip_gradients=1.0):
        _assert_trees_close(got, want)


def test_iter_size_averages_micro_steps():
    applied = []
    start = None
    for want, got, opt in _run_both(4, base_lr=0.1, stepsize=1, iter_size=2):
        _assert_trees_close(got, want)
        applied.append(opt.count)
        start = start or got
    assert applied == [0, 1, 1, 2]  # an update on every second call


def test_frozen_kernels_decay_and_biases_do_not():
    """No gradient is a zero gradient: the frozen kernel still shrinks by
    lr * weight_decay * w, its bias stays (no decay on biases)."""
    rs = np.random.RandomState(1)
    w = torch.nn.Parameter(torch.tensor(rs.randn(4, 3, 3, 3).astype(np.float32)))
    b = torch.nn.Parameter(torch.tensor(rs.randn(4).astype(np.float32)))
    w0, b0 = w.detach().clone(), b.detach().clone()
    opt = CaffeSGD([("trunk.conv1_1.weight", w), ("trunk.conv1_1.bias", b)], base_lr=0.1,
                   weight_decay=0.01)
    assert opt.step()
    np.testing.assert_allclose(w.detach().numpy(), (w0 * (1 - 0.1 * 0.01)).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(b.detach().numpy(), b0.numpy())


def test_step_lr_and_state_round_trip():
    s = step_lr(1.0, 0.1, 100)
    assert s(0) == 1.0 and s(99) == 1.0 and abs(s(100) - 0.1) < 1e-12
    a = torch.nn.Parameter(torch.ones(3))
    opt = CaffeSGD([("m.l.weight", a)], base_lr=0.1)
    a.grad = torch.full((3,), 2.0)
    opt.step()
    a2 = torch.nn.Parameter(a.detach().clone())
    opt2 = CaffeSGD([("m.l.weight", a2)], base_lr=0.1)
    opt2.load_state_dict(opt.state_dict())
    for o, p in ((opt, a), (opt2, a2)):
        p.grad = torch.full((3,), 1.0)
        o.step()
    np.testing.assert_array_equal(a.detach().numpy(), a2.detach().numpy())
    assert opt2.count == 2
