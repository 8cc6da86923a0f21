"""The height-sharded trunk (``parallel/spatial.py::spatial_trunk_features``)
over kernel D and the int8 layers (kernels E and F), on gloo CPU ranks
(``tests/torch_dist_worker.py``), where each kernel runs as its plain
version.

- Kernel D (``NET.FUSED_BLOCK1``, a bf16 VGG-16): the gathered features bit
  for bit the port's unsharded ``model.features`` (each rank hands D two
  rows of each inner neighbour and drops the pooled row its zero padding
  spoils), on 2 ranks and on 4 (two ranks with both edges inner); against
  JAX's ``spatial_trunk_features`` with the Pallas ``fused_block1`` in
  interpret mode on 2 CPU devices, within the bound that
  ``tests/test_torch_block1.py`` holds the fused trunk to JAX's (rtol 0.15,
  atol 0.05: one-ulp deviations of block 1 pass through 11 more bf16
  layers).
- int8 (``TEST.INT8``): VGG-16 and ResNet-50 v1 and v1.5 (the 7×7/s2/p3
  stem, the 1×1/s2 projections, the 3×3/s2 convolutions), f32: bit for bit
  the unsharded int8 trunk (the ranks take the largest of their scales,
  the whole tensor's), on 2 ranks (VGG-16 also on 4); against JAX's
  unsharded ``MNC.features`` evaluated op by op bit for bit, the bound of
  ``tests/test_torch_quant.py``.  JAX's ``spatial_trunk_features`` jits,
  and under ``jit`` XLA rewrites the quantization's division (see that
  file), so the op-by-op unsharded features, which the SPMD function
  computes, are the reference.
- Kernel F's plain halves: ``act_scale`` of the parts, maxed, and
  ``quant_with_scale`` of each part under it, bit for bit ``quant_act`` of
  the whole tensor (f32 and bf16; random data, quant_act's edge values,
  a part of zeros, a part far above the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnc_tpu.models.mnc import MNC as JMNC, MNCArch as JArch
from mnc_tpu.parallel import make_mesh as j_make_mesh
from mnc_tpu.parallel.spatial import shard_image as j_shard_image
from mnc_tpu.parallel.spatial import spatial_trunk_features as j_spatial
from mnc_tpu_torch.models.mnc import MNC
from mnc_tpu_torch.ops import quant as Q
from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_cuda import _quant_edge
from tests.test_torch_parallel import ARCH_KW, arch, run_ranks
from tests.test_torch_resnet import randomize_bn
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

# name: (trunk, ResNet v1.5, compute dtype, NET.FUSED_BLOCK1, TEST.INT8)
CASES = {
    "vgg_block1": ("vgg16", False, "bfloat16", True, False),
    "vgg_int8": ("vgg16", False, "float32", False, True),
    "resnet50_int8": ("resnet50", False, "float32", False, True),
    "resnet50_v15_int8": ("resnet50", True, "float32", False, True),
}
FOUR_RANKS = ("vgg_block1", "vgg_int8")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _arch_kw(name) -> dict:
    trunk, v15, dtype, block1, int8 = CASES[name]
    return dict(ARCH_KW, canvas=[64, 96], anchor_scales=[1, 2, 4], trunk=trunk, fc_dim=32,
                mask_fc_dim=16, pre_nms_top_n=32, post_nms_top_n=8,
                resnet_stride_in_3x3=v15, compute_dtype=dtype, fused_block1=block1,
                int8_inference=int8)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """One 64×96 image; each case's parameters (the port's seeded f32 init,
    random FrozenBN leaves); the features gathered from 2 ranks and, for
    ``FOUR_RANKS``, from 4."""
    rs = np.random.RandomState(6)
    image = (60 * rs.randn(64, 96, 3)).astype(np.float32)
    params, arrays = {}, {"image": image}
    for name in CASES:
        kw = dict(_arch_kw(name), compute_dtype="float32", fused_block1=False,
                  int8_inference=False)
        p = jax_params_from_state_dict(MNC(arch(**kw), device="cpu", seed=1).state_dict())
        params[name] = randomize_bn(p, rs) if CASES[name][0] != "vgg16" else p
        arrays.update({f"{name}/{k}": v.numpy()
                       for k, v in state_dict_from_jax(params[name]).items()})
    tmp = tmp_path_factory.mktemp("spatial_kernels")
    feats = {}
    for world, names in ((2, tuple(CASES)), (4, FOUR_RANKS)):
        sub = {k: v for k, v in arrays.items() if k == "image" or k.split("/")[0] in names}
        outs = run_ranks(tmp, "spatial", world, {"trunks": {n: _arch_kw(n) for n in names}},
                         sub)
        for n in names:
            assert [o[f"feat/{n}"].shape[0] for o in outs] == [4 // world] * world
            feats[n, world] = np.concatenate([o[f"feat/{n}"] for o in outs])
    return image, params, feats


def _unsharded(name, params, image) -> np.ndarray:
    model = MNC(arch(**_arch_kw(name)), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the same float sums
    try:
        with torch.no_grad():
            return model.features(torch.from_numpy(image)[None])[0].float().numpy()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,world", [(n, 2) for n in CASES] + [(n, 4) for n in FOUR_RANKS])
def test_sharded_trunk_equals_the_unsharded_trunk(sharded, name, world):
    image, params, feats = sharded
    want = _unsharded(name, params[name], image)
    got = feats[name, world]
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want, err_msg=f"{name} on {world} ranks")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_trunk_matches_jax(sharded, name):
    image, params, feats = sharded
    trunk, v15, dtype, block1, int8 = CASES[name]
    kw = _arch_kw(name)
    jm = JMNC(arch=JArch(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
                         warp_hw=4, trunk=trunk, fc_dim=32, mask_fc_dim=16,
                         pre_nms_top_n=32, post_nms_top_n=8, rpn_min_size=4.0,
                         compute_dtype=JDT[dtype], resnet_stride_in_3x3=v15,
                         fused_block1=block1, int8_inference=int8))
    assert (kw["fused_block1"], kw["int8_inference"]) == (block1, int8)
    got = feats[name, 2]
    if block1:  # the SPMD function itself, the Pallas kernel in interpret mode
        mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
        want = np.asarray(jax.device_get(j_spatial(jm, mesh)(params[name],
                                                               j_shard_image(image, mesh))))
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=0.15, atol=0.05)
    else:  # op by op: what the SPMD function computes, with the source's arithmetic
        want = jm.apply(params[name], jnp.asarray(image), method=JMNC.features)
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("data", ["random", "edges", "zero_part", "absmax_part"])
def test_kernel_f_halves_compose_to_quant_act(dtype, data):
    """Split into two parts (its first 3 rows and the rest): the largest of
    the parts' ``act_scale`` is the whole tensor's, and the parts quantized
    under it (``quant_with_scale``, and the ops ``mnc::act_scale`` /
    ``mnc::quant_with_scale``) concatenate to ``quant_act`` of the whole,
    bit for bit."""
    if data == "edges":  # quant_act's edge values (tests/test_torch_cuda.py)
        x = _quant_edge(dtype, False)
    else:
        x = (torch.randn(8, 6, 40, generator=torch.Generator().manual_seed(11)) * 3).to(dtype)
    if data == "zero_part":
        x[:3] = 0
    elif data == "absmax_part":
        x[3:] *= 0.01
    want_q, want_s = Q.quant_act(x, False)
    parts = (x[:3].contiguous(), x[3:].contiguous())
    for scale_of, quant in ((Q.act_scale, Q.quant_with_scale),
                            (Q.act_scale_op, Q.quant_with_scale_op)):
        scale = torch.stack([scale_of(p) for p in parts]).max()
        assert scale.dtype == torch.float32 and scale.shape == ()
        assert torch.equal(scale, want_s)
        q = torch.cat([quant(p, scale) for p in parts])
        assert q.dtype == torch.int8 and torch.equal(q, want_q)
    assert torch.equal(Q.act_scale(x, True), Q.quant_act(x, True)[1])
