"""The port's fused VGG block 1 on the CPU: ``block1_plain`` (the plain twin of
kernel D) against the JAX package's ``block1_reference`` and against its
Pallas kernel ``fused_block1`` in interpret mode, and
``VGG16Trunk(fused_block1=True)`` against the JAX trunk with the same flag.

Tolerance: at most 1 bf16 ulp at every element, as the JAX package's own
test states it: |diff| <= 2^-7 * max(|reference|, 1); the border rows and
columns are checked on their own.  The trunk comparison allows rtol 0.15 /
atol 0.05 (1-ulp deviations pass through 11 more bf16 layers), as
``tests/test_block1_kernel.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.vgg import VGG16Trunk as JTrunk
from mnc_tpu.ops.pallas.block1_kernel import block1_reference
from mnc_tpu.ops.pallas.block1_kernel import fused_block1 as j_fused_block1
from mnc_tpu_torch.models.vgg import VGG16Trunk
from mnc_tpu_torch.ops.block1 import block1_plain, fused_block1
from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax

BF16_ULP = 2.0 ** -7


def _params(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(3, 3, 3, 64).astype(np.float32) * 0.1, rs.randn(64).astype(np.float32),
            rs.randn(3, 3, 64, 64).astype(np.float32) * 0.05, rs.randn(64).astype(np.float32))


def _plain(x, p):
    w1, b1, w2, b2 = p  # HWIO -> OIHW
    oihw = lambda w: torch.tensor(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    return block1_plain(torch.tensor(x), oihw(w1), torch.tensor(b1), oihw(w2),
                        torch.tensor(b2)).float().numpy()


def _assert_ulp_close(got, ref):
    d = np.abs(got - ref)
    tol = BF16_ULP * np.maximum(np.abs(ref), 1.0)
    assert (d <= tol).all(), f"max dev {d.max()} vs tol {tol.flat[d.argmax()]}"
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert (d[edge] <= tol[edge]).all()


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 16, 40, 3)])
def test_block1_plain_matches_reference_and_pallas(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32) * 50
    p = _params(7)
    got = _plain(x, p)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    ref = np.asarray(block1_reference(jnp.asarray(x), *map(jnp.asarray, p)), np.float32)
    _assert_ulp_close(got, ref)
    pallas = np.asarray(j_fused_block1(jnp.asarray(x), *map(jnp.asarray, p), 2), np.float32)
    _assert_ulp_close(got, pallas)


def test_block1_plain_edge_zero_padding():
    """conv1_2 pads conv1_1's OUTPUT with zeros: a constant image makes a
    halo mistake (relu(b1) leaking in) visible at the borders."""
    p = _params(3)
    x = np.full((1, 16, 16, 3), 7.0, np.float32)
    ref = np.asarray(block1_reference(jnp.asarray(x), *map(jnp.asarray, p)), np.float32)
    _assert_ulp_close(_plain(x, p), ref)


def test_block1_plain_gradients_match_reference_vjp():
    rs = np.random.RandomState(5)
    p = _params(5)
    x = rs.randn(1, 16, 16, 3).astype(np.float32)

    def jloss(x, *p):
        return jnp.sum(block1_reference(x, *p).astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *map(jnp.asarray, p))
    w1, b1, w2, b2 = p
    args = [torch.tensor(x), torch.tensor(w1.transpose(3, 2, 0, 1).copy()), torch.tensor(b1),
            torch.tensor(w2.transpose(3, 2, 0, 1).copy()), torch.tensor(b2)]
    for a in args:
        a.requires_grad_()
    (fused_block1(*args).float() ** 2).sum().backward()
    got = [args[0].grad, args[1].grad.permute(2, 3, 1, 0), args[2].grad,
           args[3].grad.permute(2, 3, 1, 0), args[4].grad]
    for g, w in zip(got, want):
        # the JAX backward runs in bf16 and rounds every intermediate; the
        # plain twin's runs in f32: 10% of each gradient's max
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=0.05,
                                   atol=0.1 * np.abs(np.asarray(w, np.float32)).max())


def _bridged_trunks(x, **kw):
    jt = JTrunk(**kw)
    params = JTrunk().init(jax.random.PRNGKey(0), jnp.asarray(x))
    trunk = VGG16Trunk(torch.bfloat16, frozen_blocks=0, fused_block1=kw.get("fused_block1",
                                                                             False))
    sd = state_dict_from_jax({"params": {"trunk": params["params"]}})
    trunk.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jt, params, trunk


def test_trunk_fused_block1_matches_jax_trunk():
    rs = np.random.RandomState(1)
    x = rs.randn(1, 16, 32, 3).astype(np.float32) * 10
    jt, params, trunk = _bridged_trunks(x, fused_block1=True)
    want = np.asarray(jt.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = trunk(torch.tensor(x)).float().numpy()
        unfused = VGG16Trunk(torch.bfloat16, 0, False)
        unfused.load_state_dict(trunk.state_dict())
        base = unfused(torch.tensor(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.15, atol=0.05)
    np.testing.assert_allclose(got, base, rtol=0.15, atol=0.05)


def test_trunk_fused_block1_shape_rule():
    """H % 8 != 0 takes the unfused layers: the same program, bit for bit.
    The rule looks at the shape only."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 20, 16, 3).astype(np.float32)
    _, _, trunk = _bridged_trunks(x, fused_block1=True)
    unfused = VGG16Trunk(torch.bfloat16, 0, False)
    unfused.load_state_dict(trunk.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(trunk(torch.tensor(x)).float().numpy(),
                                      unfused(torch.tensor(x)).float().numpy())
