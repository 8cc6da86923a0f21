"""``MNCArch.remat_trunk`` (``torch.utils.checkpoint`` around the trunk) changes
memory, not math: one train step's loss and every gradient bit for bit
equal to the same model without it, on the CPU, for VGG-16 (f32, and bf16
with ``fused_block1``, whose kernel-D twin then runs again in the backward)
and a small ResNet (FrozenBN, its stem and stage 2 frozen).  The JAX
package's ``tests/test_train.py::test_remat_trunk_matches_plain`` makes the
same claim for ``nn.remat``.  That the checkpoint is in force is shown by
the tensors autograd keeps: the trunk's activations are not among them.
"""

import dataclasses

import pytest
import torch

from mnc_tpu_torch.data.synthetic import SyntheticShapes
from mnc_tpu_torch.models.mnc import MNC, MNCArch
from mnc_tpu_torch.train.loop import draw_step_randoms, mnc_loss
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

TRAIN_CFG = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                 RPN_FG_FRACTION=0.5, BATCH_SIZE=8, FG_FRACTION=0.25, FG_THRESH=0.5,
                 BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
SMALL = dict(canvas=(64, 96), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9, warp_hw=4,
             fc_dim=32, mask_fc_dim=16, pre_nms_top_n=96, post_nms_top_n=24, rpn_min_size=4.0)
CASES = {
    "vgg16_f32": dict(compute_dtype=torch.float32, trunk_frozen=0),
    "vgg16_bf16_fused_block1": dict(compute_dtype=torch.bfloat16, fused_block1=True),
    "resnet50_frozen": dict(compute_dtype=torch.float32, trunk="resnet50"),
}


def _saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves while ``fn`` runs."""
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return total[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_trunk_matches_plain(case):
    arch = MNCArch(**SMALL, **CASES[case])
    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=4, max_gt=4, gt_mask_size=16,
                           n_range=(1, 3), seed=3)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([0, 1]).items()}
    draws = draw_step_randoms(torch.Generator().manual_seed(5), arch, TRAIN_CFG, 2, 4)
    res, saved = {}, {}
    for remat in (False, True):
        a = dataclasses.replace(arch, remat_trunk=remat)
        model = MNC(a, device="cpu", seed=1, train=True)
        if a.trunk != "vgg16":  # init gives identity blocks (every bn3 scale 0)
            gen = torch.Generator().manual_seed(2)
            for name, p in model.named_parameters():
                if name.endswith(("bn1.scale", "bn2.scale", "bn3.scale")):
                    p.data.uniform_(0.5, 1.5, generator=gen)
        saved[remat] = _saved_bytes(lambda m=model: m.features(batch["image"]))
        total, losses = mnc_loss(model, batch, draws, a, model.anchors, TRAIN_CFG)
        total.backward()
        res[remat] = ({k: v.detach() for k, v in losses.items()},
                      {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    (plain_l, plain_g), (remat_l, remat_g) = res[False], res[True]
    for k, v in plain_l.items():
        assert torch.equal(remat_l[k], v), k
    assert set(remat_g) == set(plain_g)
    assert any(n.startswith("trunk.") for n in plain_g)
    for n, g in plain_g.items():
        assert torch.equal(remat_g[n], g), n
    assert saved[True] < saved[False] / 10, saved  # the trunk keeps no activations


def test_remat_trunk_is_off_by_default_and_not_read_from_cfg():
    assert MNCArch().remat_trunk is False
    assert MNCArch.from_cfg(train=True).remat_trunk is False
