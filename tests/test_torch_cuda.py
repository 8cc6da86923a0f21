"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes that the serving path does not reach (``chip_smoke.py``
covers the serving and training shapes and the whole pipeline, card against
CPU), and at the cases a chunked NMS scan and a footprint-summing RoI-warp
backward get wrong first.  Marked ``cuda``; without a GPU every test skips.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances: NMS keeps identical; RoI warp ≤1e-5·max|F| in f32 and
2 bf16 ulps of max|F| in bf16; its gradients ≤1e-5 (features) and ≤1e-4
(boxes) of each gradient's max in f32; paste bit for bit except pixels whose
f32 product lies within 1e-5 of the threshold; block 1 within
``block1_tolerance`` with at least 0.999 of the elements bit-identical.
"""

import pytest
import torch

from mnc_tpu_torch import kernels
from mnc_tpu_torch.ops.masks import _paste_axis_weights, paste_binarize_plain
from mnc_tpu_torch.ops.nms import nms_keep_plain
from mnc_tpu_torch.ops.roi_warp import roi_warp_plain
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _boxes(gen, shape, h, w, lo=2.0, hi=80.0):
    x1 = torch.rand(shape, generator=gen, device="cuda") * (w + 20) - 10
    y1 = torch.rand(shape, generator=gen, device="cuda") * (h + 20) - 10
    bw = lo + torch.rand(shape, generator=gen, device="cuda") * (hi - lo)
    bh = lo + torch.rand(shape, generator=gen, device="cuda") * (hi - lo)
    return torch.stack([x1, y1, x1 + bw, y1 + bh], -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,w,c,out_hw", [(1, 1, 3, 5, 8, (1, 1)),
                                              (2, 37, 12, 16, 24, (7, 5)),
                                              (3, 304, 40, 64, 512, (14, 14))])
def test_roi_warp_kernel_matches_plain(gen, dtype, b, n, h, w, c, out_hw):
    feat = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dtype)
    rois = _boxes(gen, (b, n), 16 * h, 16 * w, hi=16 * h)
    got = kernels.roi_warp_cuda(feat, rois, out_hw, 1.0 / 16)
    want = roi_warp_plain(feat, rois, out_hw, 1.0 / 16)
    scale = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= scale * feat.float().abs().max().item()


@pytest.mark.parametrize("b,n,h,w,c,out_hw", [(1, 1, 3, 5, 8, (1, 1)),
                                              (2, 37, 12, 16, 24, (7, 5)),
                                              (2, 128, 40, 64, 512, (14, 14))])
def test_roi_warp_bwd_kernel_matches_plain(gen, b, n, h, w, c, out_hw):
    """Kernel A′ through ``roi_warp`` (the autograd Function) against
    autograd through the plain version, with boxes on integer bin centers
    and over the map's edge among them."""
    from mnc_tpu_torch.ops.roi_warp import roi_warp

    feat = torch.randn(b, h, w, c, generator=gen, device="cuda")
    rois = _boxes(gen, (b, n), 16 * h, 16 * w, hi=16 * h)
    rois[0, 0] = torch.tensor([16.0, 16.0, 16.0 + 16 * out_hw[1] - 1, 16.0 + 16 * out_hw[0] - 1],
                              device="cuda")
    rois[-1, -1] = torch.tensor([-16.0, 16.0 * (h - 1), 16.0 * out_hw[1] - 17,
                                 16.0 * (h - 1) + 16 * out_hw[0] - 1], device="cuda")
    cot = torch.randn(b, n, *out_hw, c, generator=gen, device="cuda")
    kernels.reset_launch_counts()
    f, r = feat.clone().requires_grad_(), rois.clone().requires_grad_()
    roi_warp(f, r, out_hw, 1.0 / 16).backward(cot)
    assert kernels.roi_warp_cuda.launches == 1 and kernels.roi_warp_bwd_cuda.launches == 1
    fp, rp = feat.clone().requires_grad_(), rois.clone().requires_grad_()
    wf, wr = torch.autograd.grad(roi_warp_plain(fp, rp, out_hw, 1.0 / 16), (fp, rp), cot)
    assert (f.grad - wf).abs().max().item() <= 1e-5 * wf.abs().max().item()
    assert (r.grad - wr).abs().max().item() <= 1e-4 * wr.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["small", "edge"])
def test_roi_warp_bwd_kernel_hard_box_sets(gen, kind, dtype):
    """Kernel A′ where its sums collide or vanish: many 1-12 px RoIs on the
    same 4 x 4 cells; the full canvas, a 1-px box, boxes wholly outside the
    map and over its corners.  f32 within 1e-5 (dF) and 1e-4 (d rois) of each
    gradient's max; bf16 against the f32 plain gradient of the same values
    within one bf16 rounding (2^-8) plus that; d rois bit-equal on a rerun."""
    b, n, h, w, c, out_hw = 2, 128, 40, 64, 512, (14, 14)
    feat = torch.randn(b, h, w, c, generator=gen, device="cuda")
    if kind == "small":
        ctr = 300.0 + torch.rand(b, n, 2, generator=gen, device="cuda") * 64.0
        half = 0.5 + torch.rand(b, n, 2, generator=gen, device="cuda") * 5.5
        rois = torch.cat([ctr - half, ctr + half], -1).contiguous()
    else:
        rois = _boxes(gen, (b, n), 16 * h, 16 * w, hi=16 * h)
        special = [[0.0, 0.0, 1023.0, 639.0], [100.0, 100.0, 100.0, 100.0],
                   [-500.0, -500.0, -300.0, -300.0], [1924.0, 100.0, 2024.0, 200.0],
                   [-40.0, -40.0, 60.0, 60.0], [964.0, 580.0, 1064.0, 680.0],
                   [-30.0, 200.0, 1054.0, 215.0]]
        for i, box in enumerate(special):
            rois[i % b, i // b] = torch.tensor(box, device="cuda")
    cot = torch.randn(b, n, *out_hw, c, generator=gen, device="cuda")
    fp, rp = feat.to(dtype).float().requires_grad_(), rois.clone().requires_grad_()
    wf, wr = torch.autograd.grad(roi_warp_plain(fp, rp, out_hw, 1.0 / 16), (fp, rp),
                                 cot.to(dtype).float())
    gf, gr = kernels.roi_warp_bwd_cuda(cot.to(dtype), feat.to(dtype), rois, 1.0 / 16)
    tol_f = 1e-5 if dtype == torch.float32 else 2.0 ** -8 + 1e-5
    assert (gf.float() - wf).abs().max().item() <= tol_f * wf.abs().max().item()
    assert (gr - wr).abs().max().item() <= 1e-4 * wr.abs().max().item()
    again = kernels.roi_warp_bwd_cuda(cot.to(dtype), feat.to(dtype), rois, 1.0 / 16)
    assert torch.equal(again[1], gr)
    if kind == "edge":  # nothing reaches a box that lies wholly outside the map
        assert not gr[0, 1].any() and not gr[1, 1].any()


def test_bin_centers_on_the_card_equal_the_cpu(gen):
    """The centers divide by a tensor: by a Python scalar the card would
    multiply by a reciprocal and land an ulp off the CPU's (and JAX's)
    quotient, off the integer where the hat's gradient jumps."""
    from mnc_tpu_torch.ops.roi_warp import bin_centers

    rois = torch.tensor([[[32.0, 16.0, 255.0, 239.0], [3.0, 7.0, 300.5, 99.25]]], device="cuda")
    for axis in (0, 1):
        assert torch.equal(bin_centers(rois, 14, 1.0 / 16, axis).cpu(),
                           bin_centers(rois.cpu(), 14, 1.0 / 16, axis))


@pytest.mark.parametrize("shape", [(1, 8, 2, 3), (3, 40, 50, 3), (2, 640, 1024, 3),
                                   (1, 22, 130, 3), (4, 640, 1024, 3)])
def test_block1_kernel_matches_plain(gen, shape):
    from mnc_tpu_torch.ops.block1 import (block1_plain, block1_tolerance, conv_relu_plain,
                                          fused_block1)

    w1 = torch.randn(64, 3, 3, 3, generator=gen, device="cuda") * 0.1
    b1 = torch.randn(64, generator=gen, device="cuda")
    w2 = torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05
    b2 = torch.randn(64, generator=gen, device="cuda")
    x = torch.randn(shape, generator=gen, device="cuda") * 50
    kernels.reset_launch_counts()
    got = fused_block1(x, w1, b1, w2, b2).float()
    assert kernels.block1_cuda.launches == 1
    want = block1_plain(x, w1, b1, w2, b2).float()
    o1_max = conv_relu_plain(x.to(torch.bfloat16).permute(0, 3, 1, 2), w1, b1).float().max()
    assert ((got - want).abs() <= block1_tolerance(want, o1_max.item(), w2, b2)).all()
    assert (got == want).float().mean().item() >= 0.999


def test_block1_kernel_rejects_odd_sizes(gen):
    bf = torch.bfloat16
    z = lambda *s: torch.zeros(*s, device="cuda", dtype=bf)  # noqa: E731
    with pytest.raises(ValueError, match="even H, W"):
        kernels.block1_cuda(z(1, 7, 8, 3), z(64, 32), z(64), z(9, 64, 64), z(64))
    with pytest.raises(ValueError, match="w2p"):
        kernels.block1_cuda(z(1, 8, 8, 3), z(64, 32), z(64), z(3, 3, 64, 64), z(64))


def test_block1_kernel_follows_in_place_weight_updates(gen):
    """The packed weights are cached per version: after an in-place update
    the kernel sees the new weights."""
    from mnc_tpu_torch.ops.block1 import block1_plain, fused_block1

    w1 = torch.randn(64, 3, 3, 3, generator=gen, device="cuda") * 0.1
    b1 = torch.randn(64, generator=gen, device="cuda")
    w2 = torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05
    b2 = torch.randn(64, generator=gen, device="cuda")
    x = torch.randn(1, 16, 64, 3, generator=gen, device="cuda") * 50
    before = fused_block1(x, w1, b1, w2, b2)
    w2.mul_(-1.0)
    b1.add_(0.5)
    after = fused_block1(x, w1, b1, w2, b2).float()
    want = block1_plain(x, w1, b1, w2, b2).float()
    assert not torch.equal(after, before.float())
    assert (after == want).float().mean().item() >= 0.999


def test_nms_kernel_train_shape(gen):
    """The train step's proposal NMS: 2 problems of 12000, stop at 2000."""
    boxes = _boxes(gen, (2, 12000), 640, 1024, lo=16.0, hi=300.0)
    valid = torch.arange(12000, device="cuda").expand(2, 12000) < 11000
    got = kernels.nms_keep_cuda(boxes, valid.contiguous(), 0.7, 2000)
    assert torch.equal(got, nms_keep_plain(boxes, valid, 0.7, 2000))
    assert int(got.sum(1).max()) <= 2000


def test_roi_warp_kernel_rejects_bad_inputs(gen):
    feat = torch.zeros(1, 4, 4, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.roi_warp_cuda(feat, torch.zeros(1, 2, 4, device="cuda"), (2, 2), 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.roi_warp_cuda(torch.zeros(1, 4, 4, 16, device="cuda").transpose(1, 2),
                              torch.zeros(1, 2, 4, device="cuda"), (2, 2), 0.25)


@pytest.mark.parametrize("p,k", [(1, 1), (3, 63), (2, 65), (5, 130), (1, 2000)])
@pytest.mark.parametrize("thresh,top_n", [(0.3, 0), (0.7, 0), (0.5, 10)])
def test_nms_kernel_matches_plain(gen, p, k, thresh, top_n):
    boxes = _boxes(gen, (p, k), 200, 300, lo=4.0, hi=60.0)
    valid = torch.rand(p, k, generator=gen, device="cuda") > 0.2
    got = kernels.nms_keep_cuda(boxes, valid, thresh, top_n)
    want = nms_keep_plain(boxes, valid, thresh, top_n)
    assert torch.equal(got, want)
    if top_n:
        assert int(got.sum(1).max()) <= top_n


@pytest.mark.parametrize("k", [304, 6001, 12000])
def test_nms_kernel_chain_across_chunks(gen, k):
    """Box i suppresses only box i + 1: keeps alternate across every chunk
    border of the scan and each chunk's resolution takes as many rounds as it
    is long; an invalid box breaks the chain.  K = 304 runs in one block, the
    larger ones on a cluster."""
    x = 20.0 * torch.arange(k, device="cuda", dtype=torch.float32)
    boxes = torch.stack([x, torch.zeros_like(x), x + 100.0, torch.full_like(x, 100.0)], -1)
    boxes = boxes.expand(2, k, 4).contiguous()
    valid = torch.ones(2, k, dtype=torch.bool, device="cuda")
    valid[1, 64] = valid[1, 191] = False
    for top_n in (0, 33):
        got = kernels.nms_keep_cuda(boxes, valid, 0.5, top_n)
        assert torch.equal(got, nms_keep_plain(boxes, valid, 0.5, top_n))
    full = kernels.nms_keep_cuda(boxes, valid, 0.5, 0)
    assert torch.equal(full[0], torch.arange(k, device="cuda") % 2 == 0)
    assert full[1, 63:67].tolist() == [False, False, True, False]


@pytest.mark.parametrize("k", [304, 6001, 12000])
@pytest.mark.parametrize("every_third_invalid", [False, True])
def test_nms_kernel_stop_inside_a_chunk(gen, k, every_third_invalid):
    """Disjoint boxes: every valid box is a keep, so the scan stops exactly
    where top_n says: on the last box of a chunk, the first of the next, a
    middle one, the very last box, and never."""
    i = torch.arange(k, device="cuda")
    xy = torch.stack([150.0 * (i % 100), 150.0 * (i // 100)], -1).float()
    boxes = torch.cat([xy, xy + 99.0], -1)[None].contiguous()
    valid = (i % 3 != 1)[None].contiguous() if every_third_invalid else torch.ones(
        1, k, dtype=torch.bool, device="cuda")
    n_valid = int(valid.sum())
    for top_n in (0, 1, 43, 44, 64, 65, 100, 128, 129, n_valid - 1, n_valid, n_valid + 7):
        got = kernels.nms_keep_cuda(boxes, valid, 0.7, top_n)
        assert torch.equal(got, nms_keep_plain(boxes, valid, 0.7, top_n))
        assert int(got.sum()) == (min(top_n, n_valid) if top_n else n_valid)


@pytest.mark.parametrize("trailing", [False, True])
def test_nms_kernel_heavy_suppression_full_k(gen, trailing):
    """Clustered boxes at the train step's K with a low threshold (most boxes
    are suppressed by keeps of earlier chunks), invalid boxes interleaved and
    trailing, the stop around a chunk's border."""
    k = 12000
    centers = _boxes(gen, (2, 300), 640, 1024, lo=24.0, hi=300.0)
    pick = torch.randint(0, 300, (2, k), generator=gen, device="cuda")
    boxes = torch.gather(centers, 1, pick[..., None].expand(2, k, 4))
    boxes = boxes + (torch.rand(2, k, 4, generator=gen, device="cuda") - 0.5) * 40.0
    boxes[..., 2:] = torch.maximum(boxes[..., 2:], boxes[..., :2] + 1.0)
    boxes = boxes.contiguous()
    valid = (torch.arange(k, device="cuda").expand(2, k) < 8400 if trailing
             else torch.rand(2, k, generator=gen, device="cuda") > 0.3).contiguous()
    for top_n in (0, 63, 64, 65):
        got = kernels.nms_keep_cuda(boxes, valid, 0.3, top_n)
        assert torch.equal(got, nms_keep_plain(boxes, valid, 0.3, top_n))


def test_nms_kernel_duplicates_and_all_invalid(gen):
    boxes = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device="cuda").expand(2, 300, 4)
    valid = torch.ones(2, 300, dtype=torch.bool, device="cuda")
    valid[1] = False
    keep = kernels.nms_keep_cuda(boxes.contiguous(), valid, 0.5)
    assert keep[0].sum() == 1 and keep[0, 0] and not keep[1].any()


@pytest.mark.parametrize("n,h,w,m", [(3, 40, 130, 9), (7, 96, 128, 28), (100, 640, 1024, 21),
                                     (400, 640, 1024, 21), (5, 97, 203, 21), (2, 33, 16, 32)])
@pytest.mark.parametrize("thresh", [0.4, -0.1])
def test_paste_kernel_matches_plain(gen, n, h, w, m, thresh):
    boxes = _boxes(gen, (n,), h, w, lo=1.0, hi=max(h, w) / 2)
    masks = torch.rand(n, m, m, generator=gen, device="cuda")
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], m, h).contiguous()
    wxt = _paste_axis_weights(boxes[:, 0], boxes[:, 2], m, w).transpose(1, 2).contiguous()
    got = kernels.paste_binarize_cuda(wy, masks, wxt, thresh)
    prod = torch.bmm(torch.bmm(wy, masks), wxt)
    want = paste_binarize_plain(wy, masks, wxt, thresh)
    mism = got != want
    if mism.any():
        assert (prod[mism] - thresh).abs().max().item() < 1e-5


@pytest.mark.parametrize("h,w", [(640, 1024), (97, 203)])
@pytest.mark.parametrize("thresh", [0.4, -0.1])
def test_paste_kernel_edge_boxes(gen, h, w, thresh):
    """Boxes wholly outside the canvas, of 1 px, over the full canvas and
    beyond, on its edges: pixels outside a box take 0 > thresh, the rest
    agree with the f32 product."""
    boxes = torch.tensor([[-500.0, -500.0, -300.0, -300.0], [w + 100.0, 10.0, w + 300.0, 30.0],
                          [7.0, 7.0, 7.0, 7.0], [20.5, 10.25, 20.5, 10.25],
                          [0.0, 0.0, w - 1.0, h - 1.0], [-40.0, -40.0, w + 40.0, h + 40.0],
                          [w - 1.0, h - 1.0, w - 1.0, h - 1.0], [13.0, 3.0, 35.0, h - 9.0]],
                         device="cuda")
    masks = torch.rand(len(boxes), 21, 21, generator=gen, device="cuda")
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], 21, h).contiguous()
    wxt = _paste_axis_weights(boxes[:, 0], boxes[:, 2], 21, w).transpose(1, 2).contiguous()
    got = kernels.paste_binarize_cuda(wy, masks, wxt, thresh)
    prod = torch.bmm(torch.bmm(wy, masks), wxt)
    mism = got != (prod > thresh)
    if mism.any():
        assert (prod[mism] - thresh).abs().max().item() < 1e-5
    outside = ~((wy != 0).any(-1)[:, :, None] & (wxt != 0).any(-2)[:, None, :])
    assert (got[outside] == (0.0 > thresh)).all()
    assert (got[0] == (0.0 > thresh)).all() and (got[1] == (0.0 > thresh)).all()



def test_proposals_and_bridge_break_ties_as_on_the_cpu(gen):
    """Exact score ties (bf16-rounded RPN logits) and tied foreground classes
    resolve to the lower index on the card, as on the CPU (and in JAX)."""
    from mnc_tpu_torch.models.mnc import MNCArch, propose_rois, stage_bridge

    arch = MNCArch(pre_nms_top_n=6000, post_nms_top_n=304)
    fh, fw = arch.feat_hw
    cls = torch.randn(2, fh, fw, 2 * arch.num_anchors, generator=gen, device="cuda")
    cls = cls.to(torch.bfloat16).float()
    box = 0.3 * torch.randn(2, fh, fw, 4 * arch.num_anchors, generator=gen, device="cuda")
    info = torch.tensor([[640.0, 1024.0, 1.0], [600.0, 900.0, 0.9]], device="cuda")
    anchors = torch.from_numpy(arch.all_anchors())
    got = propose_rois(cls, box, info, anchors.cuda(), arch)
    want = propose_rois(cls.cpu(), box.cpu(), info.cpu(), anchors, arch)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=0, atol=1e-6)

    n, c = 304, 21
    prob = torch.full((2, n, c), 1.0 / c, device="cuda")  # every class ties
    pred = 0.1 * torch.randn(2, n, 4 * c, generator=gen, device="cuda")
    rois = got[0]
    on_card = stage_bridge(rois, prob, pred, info, arch)
    on_cpu = stage_bridge(rois.cpu(), prob.cpu(), pred.cpu(), info.cpu(), arch)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,w,s", [(333, 500, 600 / 333), (500, 375, 1.6), (1200, 1600, 0.5),
                                   (1601, 1200, 0.5), (64, 48, 3.3)])
def test_image_resize_on_the_card_equals_the_cpu(gen, h, w, s):
    """utils.blob.resize_linear (cv2's arithmetic) is bit-equal on both
    devices: int32 ops for uint8, float64 for the f32 path's fma."""
    from mnc_tpu_torch.utils.blob import resize_linear

    im = torch.randint(0, 256, (h, w, 3), generator=gen, device="cuda", dtype=torch.uint8)
    assert torch.equal(resize_linear(im, scale=s).cpu(), resize_linear(im.cpu(), scale=s))
    f = im.float() - 120.0
    assert torch.equal(resize_linear(f, scale=s).cpu(), resize_linear(f.cpu(), scale=s))


def test_mask_resize_and_packing_on_the_card_equal_the_cpu(gen):
    from mnc_tpu_torch.pipeline.inference import _resize_mask_to, pack_bits

    masks = torch.rand(20, 600, 800, generator=gen, device="cuda") > 0.5
    full = _resize_mask_to(masks, (375, 500))
    assert torch.equal(full.cpu(), _resize_mask_to(masks.cpu(), (375, 500)))
    assert torch.equal(pack_bits(full).cpu(), pack_bits(full.cpu()))


def test_custom_ops_on_the_card_equal_the_direct_wrappers(gen):
    """mnc::roi_warp, mnc::nms_keep, mnc::paste_binarize and mnc::block1 on
    CUDA tensors launch their kernel once and give the direct wrapper's
    output, bit for bit."""
    from mnc_tpu_torch.ops.block1 import block1_op, packed_block1_weights
    from mnc_tpu_torch.ops.masks import paste_binarize_op
    from mnc_tpu_torch.ops.nms import nms_keep_op
    from mnc_tpu_torch.ops.roi_warp import roi_warp_op

    feat = torch.randn(2, 12, 16, 24, generator=gen, device="cuda").to(torch.bfloat16)
    rois = _boxes(gen, (2, 37), 192, 256)
    boxes = _boxes(gen, (3, 300), 640, 1024, lo=16.0, hi=300.0)
    valid = torch.rand(3, 300, generator=gen, device="cuda") > 0.2
    wy = _paste_axis_weights(rois[0, :, 1], rois[0, :, 3], 21, 96)
    wxt = _paste_axis_weights(rois[0, :, 0], rois[0, :, 2], 21, 128).transpose(1, 2).contiguous()
    masks = torch.rand(37, 21, 21, generator=gen, device="cuda")
    x = torch.randn(2, 40, 50, 3, generator=gen, device="cuda") * 50
    ws = (torch.randn(64, 3, 3, 3, generator=gen, device="cuda") * 0.1,
          torch.randn(64, generator=gen, device="cuda"),
          torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05,
          torch.randn(64, generator=gen, device="cuda"))
    cases = [(lambda: roi_warp_op(feat, rois, 14, 14, 1.0 / 16),
              lambda: kernels.roi_warp_cuda(feat, rois, (14, 14), 1.0 / 16), "roi_warp_cuda"),
             (lambda: nms_keep_op(boxes, valid, 0.7, 100),
              lambda: kernels.nms_keep_cuda(boxes, valid, 0.7, 100), "nms_keep_cuda"),
             (lambda: paste_binarize_op(wy, masks, wxt, 0.4),
              lambda: kernels.paste_binarize_cuda(wy, masks, wxt, 0.4), "paste_binarize_cuda"),
             (lambda: block1_op(x, *ws),
              lambda: kernels.block1_cuda(x.to(torch.bfloat16), *packed_block1_weights(*ws)),
              "block1_cuda")]
    for op, direct, wrapper in cases:
        kernels.reset_launch_counts()
        got = op()
        assert kernels.launch_counts()[wrapper] == 1
        assert torch.equal(got, direct())


def test_exported_fused_block1_program_on_the_card(gen):
    """A small bf16 model with ``fused_block1`` exported on the card: the
    artifact launches kernels D, A, B and C through their custom ops and
    gives the live pipeline's outputs, bit for bit."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.export import deserialize_inference, export_inference
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, n_stages=3, fc_dim=64, mask_fc_dim=32, pre_nms_top_n=32,
                   post_nms_top_n=8, rpn_min_size=4.0, compute_dtype=torch.bfloat16,
                   fused_block1=True)
    model = MNC(arch, device="cuda")
    post = PostCfg(dets_per_class=4, max_per_image=8)
    fn = deserialize_inference(export_inference(model, post, batch=2))
    imgs = torch.randint(0, 256, (2, 96, 128, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    infos = torch.tensor([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]], device="cuda")
    want = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    kernels.reset_launch_counts()
    got = fn(imgs, infos)
    counts = kernels.launch_counts()
    assert (counts["block1_cuda"], counts["roi_warp_cuda"], counts["nms_keep_cuda"],
            counts["paste_binarize_cuda"]) == (1, 1, 2, 1)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
