#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mnc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the two JSON lines at the end:

1. device  — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build   — compiles every kernel from ``mnc_tpu_torch/csrc`` (nvcc, sm_90a)
   and, beside them, the host helpers ``csrc/native.cpp`` (g++).
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes of the serving and training paths of both trunks (the RoI
   warp and its backward on 512 and 1024 channels, NMS per class on 80 and
   320 problems; NMS also on chains, stops
   inside a chunk and interleaved invalid boxes at full K; the RoI-warp
   backward also on many small boxes, the full canvas and boxes outside the
   map; the paste also on boxes outside the canvas, of 1 px and over all of
   it, with a negative threshold and a width that is not a multiple of 16;
   the warp also on the portrait canvas's 64x40 map, the paste also at
   M = 28 on both canvases; and at the shapes of ``cfm_detect``: the warp
   on one image's 300 segments, NMS on 20 per-class problems of 300, the
   paste at N = 100; the warp also at a train step's 2 x 128 RoIs on the
   RoI sets of its backward, in f32 and bf16, two runs bit-equal, through
   its banded path too, at N = 0 and on phase 4a's own proposals, timed over
   a CUDA graph, with the L2 tap bytes of each RoI set), and kernel E (the
   int8 GEMM) at every shape of the
   int8 serving paths (VGG-16's convolutions from conv1_1's K = 27 to the
   40x64 and 64x40 maps of conv5; fc6, fc7 and fc_mask on 1216 RoIs, fc6 on
   CFM's 300; the ResNet stem's K = 147, 1x1 and 3x3 at stride 1 and 2,
   the conv5 head's 14 -> 7; a small f32 shape with an odd Cout and a dense
   K of 300; the ResNet stage-4 1x1 convolutions), on random and on
   all-+-127 operands, bit for bit, and kernel F (the int8 activation
   quantization: its bf16 division first proved by exhaustion on 2.13e9
   pairs) at the input of every int8 layer of both trunks against
   ``quant_act`` in bf16 and f32, on random, edge-case and all-zero data,
   with one CUDA launch a call, and F's two halves (the scale alone, the
   quantization under a given scale: the spatial trunk's) over the two
   halves of H of every per-tensor input, composed bit for bit F on the
   whole, one launch each, then timed (CUDA events, after warm-up)
   beside the plain version and, where one PyTorch call computes the same
   function, that call.  NMS, the
   paste (N = 400, the serving request, and N = 100), block 1 (B = 2,
   B = 4 and the spatial trunk's slabs of 322 and 324 rows), E and F's
   halves are timed and bounded per shape.
4. main paths, each with the launch counters zeroed just before and read
   just after:
   a. serving — batched 5-stage VGG-16 at full width (640×1024 canvas, FC
      4096, pre-NMS 6000, post-NMS 304, bf16, seeded random init):
      ``MNCPipeline.detect_canvas_batch`` answers 2 requests of 4 canvases;
   b. training — the same network with f32 master parameters
      (``MNC(train=True)``, ``MNCArch.from_cfg(train=True)``: pre-NMS 12000,
      post-NMS 2000, 128 RoIs and 256 anchors per image, blocks 1-2 frozen)
      takes 3 optimizer steps on synthetic batches of 2 images; every loss
      must be finite, the parameters must move, and the stage-2/3 losses
      alone must reach ``rpn_bbox_pred``.  Then one step and one serving
      request with ``fused_block1=True`` (kernel D on the trunk), whose
      features are held against the unfused trunk's;
   c. small f32 models (VGG-16, and ResNet-50 with the conv5 head and
      random FrozenBN leaves) on the card against the same models on the
      CPU (plain versions of every kernel): the serving outputs, and one
      train step's losses, selections and gradients on the same draws;
   d. the ResNet-101 COCO configuration (``experiments/cfgs/
      mnc_coco_resnet101.yml``: 81 classes, v1 geometry, bf16, seeded random
      init) with the per-RoI conv5 head (``NET.ROI_CONV5``): 2 requests of 4
      canvases at full width, checked as in a.; then the yml as it stands
      (fc6/fc7 on 7·7·1024 inputs): one request;
   e. the same conv5 configuration in training (``from_cfg(train=True)``,
      stem and stage 2 frozen, ``CLIP_GRADIENTS`` 10): 3 steps of 2 images,
      checked as in b.;
   f. a user's images with the reference weights: a full-size seeded VGG-16
      caffemodel (mask size 28) written by the port's fabricator and
      imported with ``load_import_weights`` (auto-config to M = 28), then
      ``MNCPipeline.detect_many`` over 16 uint8 BGR images of six photo
      sizes, 5 of them portrait (the 1024x640 view of the same parameters),
      batch 4, the default TEST config; its images/s and the split of its
      time (host prep, device, device → host, host finalize); host_paste
      and single ``detect`` against the stream; then a small f32 model's
      detect_many and ``tools/test_net`` on ``synthetic_8`` (one npz), card
      against CPU;
   g. the serving entry points, on f's imported model before it is freed:
      each kernel through its custom op (``mnc::*``) against its direct
      wrapper (identical outputs, host us per call each way); the
      micro-batched HTTP server (``make_http_server(batch_fn=...)`` over
      ``detect_many``, max batch 4) answering f's 16 images as ``.npy``
      bodies from 8 client threads (requests/s, latency, batches formed,
      every RLE of its image's size); the single-mode server equal to
      ``dets_to_json(pipe.detect(im))``; the B = 4 ``torch.export``
      artifact, loaded in a fresh process that imports no model code, on
      a.'s canvases against ``detect_canvas_batch`` (the subprocess
      prints its launch counts; artifact size, export / save / load
      seconds; exported and eager request times over 60 pairs interleaved
      in one process, median and spread); ``ExportedPipeline.detect``
      against ``MNCPipeline.detect``;
   h. the CFM model family (``mnc_tpu_torch/models/cfm.py``) on 8 seeded
      640x1024 synthetic shapes images, whose MCG-format superpixel maps
      (each gt instance a superpixel of its own, then unions of grid cells)
      ``tools.prepare_mcg_maskdb`` converts into a segdb of 300 segments
      per image (one process per image): ``cfm_detect`` at full width
      (a.'s VGG-16, bf16, seeded init) on each image's 300 segments (ms per
      image; every detection's box a refined segment box); 3 CFM train
      steps at full width (``from_cfg(train=True)``, 2 images a step from
      ``TrainLoader``, 64 segments each; wall ms per step, peak memory;
      the trunk and the classify head move, the RPN and the mask head
      move by weight decay alone, bit for bit); ``cfm_detect`` on the first
      2 images with the ResNet-101 COCO configuration's conv5 head (81
      classes, random FrozenBN leaves) and with a.'s VGG-16 under
      ``TEST.INT8`` (kernels E and F); then a small f32 model's
      ``cfm_detect`` and CFM train step and ``tools/test_net --segdb`` on
      ``synthetic_8``, card against CPU;
   i. int8 serving (``TEST.INT8``, kernels F and E on every int8 layer):
      a.'s VGG-16 with ``int8_inference`` against the bf16 model of the
      same seed, 10 requests each, interleaved (median and worst ms, the
      ratio beside ``INT8_RATIO_PREDICTED``, E's and F's launches per
      request); cls_prob
      index by index against the bf16 cascade's (reported); an image's
      ``detect`` against the same image in a ``detect_many`` batch of 4 with
      wide-range batchmates (the batch-wide activation scale: the features
      must differ); ``tools.int8_audit`` on 4 synthetic 640x1024 images;
      then the ResNet-101 COCO configuration under ``TEST.INT8``, one
      request with the conv5 head and one with the fc head (checked as in
      a.; kernel F launched once less than E for each bottleneck whose
      conv1 and proj share a quantized input), each against its bf16
      cascade (6 requests each, interleaved; the outputs and detections
      bit for bit those of conv1 and proj quantizing on their own); then small f32 int8 models
      (VGG-16, ResNet-50 with the conv5 head) card against CPU;
   j. real-format datasets: an SBD tree (8 images at VOC photo sizes, both
      orientations; ``GTinst`` / ``GTcls`` structs written by
      ``scipy.io.savemat``; PNG bytes under the reference's ``.jpg``
      names) and a COCO tree (4 PNG images, 80 categories with COCO's ids,
      RLE segmentations), written here without cv2; the ground truth fed
      back as detections scores 1.0 on both; ``tools.train_net --imdb
      voc_2012_seg_train`` at full width (``from_cfg(train=True)``) from
      f.'s caffemodel (``--weights``), 4 steps with a snapshot after each; a
      second run resumed from step 2 takes step 3 (its losses equal the
      first run's, and its step-3 state bit for bit, parameter by parameter
      and momentum by momentum, as the JAX package's
      ``test_resume_reproduces_training`` requires), a third resumed from
      the first run's step-3 snapshot takes step 4 (its losses equal the
      first run's); ``tools.test_net`` over the
      SBD tree on the trained state (``pipe.detect``) and with its ground
      truth as ``--segdb``;
      ``train_net`` (2 steps) and ``test_net --coco-ap`` (4 images) over the
      COCO tree with the ResNet-101 COCO configuration's conv5 head; a small
      f32 model's ``test_net`` over the SBD tree, plain and ``--segdb``,
      card against CPU (identical AP tables);
   k. parallel training and evaluation (``mnc_tpu_torch/parallel``) on j.'s
      SBD tree: ``tools.train_net --dp`` at world 1 through NCCL (2 steps
      of 2 images, full-width VGG-16) against ``train_net`` (step 1 from
      the same init and step 2 from the DP run's step-1 snapshot: losses
      and states bit for bit: the all-reduce of one rank leaves each
      gradient as it is); the DP step against
      the plain step on one model (the all-reduce's cost at world 1, its
      gradient bytes); ``tools.test_net --dp --eval-batch 4`` on
      ``synthetic_8`` (detections equal to ``--eval-batch 1``'s, the same
      one-image runner; compared with ``--eval-batch 4``); then 2 gloo
      ranks sharing the card (``--parallel-worker``): the DP step (1 image
      a rank) against one process's per-image backward summed and halved
      (losses equal, states within ``RESUME_STATE_BOUND``: the two sum the
      gradients in different splits), the TP step ({data: 1,
      model: 2}, fc6's 25088x4096 split in two, f32 3-stage) against the
      plain step (losses within 1e-5 relative, the gathered checkpoint
      within the bound), the spatial trunk (2 x 320 rows of 640x1024, f32)
      against ``model.features`` (1e-4 of the max), through kernel D (bf16
      ``FUSED_BLOCK1``, path ``spatial_block1``: block 1's gathered rows
      bit for bit D on the whole canvas, the features within 1e-2 of the
      max) and under int8 (VGG-16, kernels E and F's halves, path
      ``spatial_int8``: bit for bit the unsharded int8 trunk), and
      ``train_net --dp`` and ``test_net --dp`` as 2 ranks (the detections
      equal world 1's).
      ``--only parallel`` builds the kernels and runs this phase alone;
   l. the train -> detect -> mAP^r tools and the last ported modules:
      ``tools.e2e_synth_demo --full-scale`` on VGG-16 (640x1024, FC 4096,
      M 21, pre-/post-NMS 2048/512, bf16; 6 steps of 2 images, an
      evaluation at step 3, ``--int8-eval``): every step's losses finite,
      every kernel moved, one EVAL line and the final JSON line, kernels E
      and F launched in the int8 evaluation only (paths ``e2e_train``,
      ``e2e_eval``, ``e2e_int8_eval``; per-step and per-evaluation walls);
      the ResNet-101 conv5 configuration, whose trunk is rematerialized
      (2 steps, path ``e2e_remat``), then one step with and one without
      ``remat_trunk`` from the same init and draws (losses and states bit
      for bit, the peak memory of each, remat's lower);
      ``tools.ablation_study`` at full scale on the trained npz (4 images over seeds 99 and 7, 50 bootstrap resamples,
      COCO AP; paths ``ablation_<variant>``, ``5stage_int8`` with E and F),
      and ``--only 3stage`` after it with the paired deltas; ``--smoke``
      on the card against the CPU (records equal but ``ms_per_img``);
      ``TEST.VOTE_IMPL gather`` against ``einsum`` on a.'s first request
      (detections equal, merged masks within 1e-5, both routes timed);
      ``roi_pool`` on a VGG conv5 map (4 x 40 x 64 x 512, 76 RoIs an
      image, 7x7) and the whole-class ``mask_voting`` / ``box_voting`` on
      one class's candidates, card against CPU; ``rle_encode`` of one
      640x1024 mask, the compiled host helper against numpy;
   m. the study tools on l.'s trained npz: ``tools.reference_parity
      --dry-run`` with random weights and with ``--fabricate proto`` (each
      through its ``test_net`` subprocess: PARITY: PASS), then the
      fabricated run's ``test_net`` argv in this process (the same mAP^r;
      path ``parity_test_net``); ``tools.workingset_study`` at full width (4
      images, pre-NMS 512 and 6000, post-NMS 304; path ``workingset``),
      ``tools.crowd_study`` at full width (2 images of 20-30 instances,
      ``--only 16,0``; path ``crowd``) and ``tools.mask_fidelity_study
      --trials 50``.
      ``--only tools`` builds the kernels and runs phases l and m alone;
   n. determinism: one full-width step of each training path twice from
      one state, one batch and one draw (the state restored in place):
      VGG-16 (5-stage, bf16, ``from_cfg(train=True)``, 2 images), the CFM
      step and the DP step at world 1 through NCCL on that network, and the
      ResNet-101 COCO configuration's conv5 head; every parameter,
      momentum, counter and metric bit for bit (the counterparts of the JAX
      package's ``test_training_is_deterministic``), then the same step
      under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
      which must list no op (a probe, ``torch.histc``, shows that it would).
      ``--only determinism`` builds the kernels and runs this phase alone.
5. the ``kernels`` JSON line (launches of phase 4 by path; times and errors
   of phase 3, per shape where there are several; bounds from this run's
   inputs), then ``{"ok": true, ...}``.

Any failure raises, so the script exits non-zero without the "ok" line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 without tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
CANVAS = (640, 1024)
PORTRAIT = (1024, 640)  # the transposed canvas that portrait images run on


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters=20, replays=3) -> float:
    """Mean device time of fn over ``iters`` calls captured in one CUDA
    graph and replayed ``replays`` times: CUDA events around the replays,
    no host work between the launches (a call whose wrapper takes longer on
    the host than its kernel on the card is otherwise paced by the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(n_bytes: float, n_flops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def traced(fn, n_top=8):
    """``fn()`` under torch.profiler, synchronized: (device busy ms, kernels
    launched, the top kernels by device time as text, wall ms traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = "; ".join(f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:60]}"
                    for e in rows[:n_top])
    return (sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows), top,
            wall_ms)


def random_boxes(g, n, h, w, lo=16.0, hi=500.0):
    """(n, 4) f32 boxes with corners up to 40 px beyond the canvas."""
    dev = "cuda"
    cx = torch.rand(n, generator=g, device=dev) * w
    cy = torch.rand(n, generator=g, device=dev) * h
    bw = lo + torch.rand(n, generator=g, device=dev) * (hi - lo)
    bh = lo + torch.rand(n, generator=g, device=dev) * (hi - lo)
    b = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return torch.maximum(torch.minimum(b, torch.tensor([w + 40.0, h + 40.0] * 2,
                                                       device=dev)),
                         torch.tensor(-40.0, device=dev))


# kernel A's shapes: (images, RoIs an image, canvas, channels); the first is the main row
ROI_WARP_SHAPES = {"C=512": (4, 304, CANVAS, 512),  # the VGG-16 conv5 map of a request
                   "C=1024": (4, 304, CANVAS, 1024),  # the ResNet conv4 map
                   "portrait 64x40, C=512": (4, 304, PORTRAIT, 512),
                   "CFM 1x300, C=512": (1, 300, CANVAS, 512),  # cfm_detect's segments
                   "train 2x128, C=512": (2, 128, CANVAS, 512)}  # a train step's RoIs
ROI_WARP_PROPOSALS = "proposals 4x304 (phase 4a), C=512"
ROI_WARP_OUT_HW, ROI_WARP_SCALE = (14, 14), 1.0 / 16
# against roi_warp_plain: f32 1e-5 of max|F|; bf16 2 ulps of it (the plain
# version rounds its hats and x-pass intermediate to bf16)
ROI_WARP_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 2 * 2.0 ** -7}


def main_path_rois():
    """Phase 4a's first request up to its proposals: the VGG-16 serving
    model of ``serve_path`` (seed 0) on the same uint8 canvases; (conv5
    features (4, 40, 64, 512) bf16, ``propose_rois``' rois (4, 304, 4))."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch, propose_rois

    arch = MNCArch(pre_nms_top_n=6000, post_nms_top_n=304, nms_chunk=256,
                   compute_dtype=torch.bfloat16)
    model = MNC(arch, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    req = torch.randint(0, 256, (4, *arch.canvas, 3), generator=g, device="cuda",
                        dtype=torch.uint8)
    infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * 4,
                         device="cuda")
    with torch.inference_mode():
        feat = model.features(req)
        rpn_cls, rpn_bbox = model.rpn(feat)
        rois, _, _ = propose_rois(rpn_cls, rpn_bbox, infos, model.anchors, arch)
    del model
    torch.cuda.empty_cache()
    return feat.clone().contiguous(), rois.clone().float().contiguous()


def check_roi_warp(g):
    """Kernel A at every shape of ``ROI_WARP_SHAPES`` on random boxes and at
    phase 4a's proposals (held, timed over a CUDA graph and back to back,
    bounded; its L2 tap bytes), on kernel A′'s RoI sets at the train shape
    (held in f32 and bf16, two runs bit-equal, the banded path bit-equal to
    the one-band launch), and at N = 0; the C = 512 row is the main row."""
    from mnc_tpu_torch.kernels import roi_warp_cuda

    shapes = {label: _check_roi_warp(g, c, canvas, b, n)
              for label, (b, n, canvas, c) in ROI_WARP_SHAPES.items()}
    feat, rois = main_path_rois()
    shapes[ROI_WARP_PROPOSALS] = _check_roi_warp(g, 512, feat=feat, rois=rois)
    b, n, canvas, c = ROI_WARP_SHAPES["train 2x128, C=512"]
    feat32 = torch.randn(b, canvas[0] // 16, canvas[1] // 16, c, generator=g, device="cuda")
    for label, rois in _bwd_box_sets(g, b, n).items():
        _hold_roi_warp(feat32, rois, f"[{label}] train 2x128")
        _hold_roi_warp_bands(feat32, rois, f"[{label}] train 2x128")
    before = roi_warp_cuda.launches
    empty = roi_warp_cuda(feat32, torch.zeros(b, 0, 4, device="cuda"), ROI_WARP_OUT_HW,
                          ROI_WARP_SCALE)
    if tuple(empty.shape) != (b, 0, *ROI_WARP_OUT_HW, c) or roi_warp_cuda.launches != before:
        raise AssertionError(f"roi_warp at N = 0: shape {tuple(empty.shape)}, "
                             f"{roi_warp_cuda.launches - before} launches")
    log(f"kernel A roi_warp N=0: shape {tuple(empty.shape)}, no launch")
    return dict(shapes["C=512"], shapes=shapes)


def _hold_roi_warp(feat32, rois, label):
    """Kernel A against roi_warp_plain in f32 and bf16 within
    ``ROI_WARP_TOLERANCES``, each dtype twice, bit-equal (no atomics);
    returns (bf16 max_abs_err, L2 tap bytes of these rois in bf16)."""
    from mnc_tpu_torch.kernels import plan_roi_warp, roi_warp_cuda, roi_warp_l2_bytes
    from mnc_tpu_torch.ops.roi_warp import roi_warp_plain

    out_hw, s = ROI_WARP_OUT_HW, ROI_WARP_SCALE
    b, h, w, c = feat32.shape
    errs = {}
    for dt, tol_scale in ROI_WARP_TOLERANCES.items():
        f = feat32.to(dt)
        got = roi_warp_cuda(f, rois, out_hw, s)
        want = roi_warp_plain(f, rois, out_hw, s)
        err = (got.float() - want.float()).abs().max().item()
        tol = tol_scale * f.float().abs().max().item()
        again = torch.equal(got, roi_warp_cuda(f, rois, out_hw, s))
        log(f"kernel A roi_warp {label} {dt} map {h}x{w} C={c}: max_abs_err {err:.3e} "
            f"(tolerance {tol:.3e}); two runs bit-equal {again}")
        if not err <= tol:
            raise AssertionError(f"roi_warp kernel disagrees with its plain version in {dt} "
                                 f"({label})")
        if not again:
            raise AssertionError(f"roi_warp: two runs differ ({label}, {dt})")
        errs[dt] = err
    l2 = roi_warp_l2_bytes(rois, out_hw, s, (h, w), c, 2,
                           plan_roi_warp(b, rois.shape[1], c, torch.bfloat16, out_hw, (h, w)))
    out_bytes = rois.shape[0] * rois.shape[1] * out_hw[0] * out_hw[1] * c * 2
    log(f"kernel A roi_warp {label}: L2 tap bytes (bf16) map slabs staged "
        f"{l2['staged'] / 1e6:.1f} MB; per-RoI staging {l2['per_roi'] / 1e6:.1f} MB; first "
        f"port's design {l2['old_per_row'] / 1e6:.1f}-{l2['old_every_tap'] / 1e6:.1f} MB; "
        f"output {out_bytes / 1e6:.1f} MB")
    return errs[torch.bfloat16], l2


def _hold_roi_warp_bands(feat32, rois, label, band_rows=13):
    """Kernel A's path for maps too large for shared memory (the map slab
    staged in bands of ``band_rows`` rows, 128-byte cells) forced on this
    map: bit for bit the one-band launch of ``roi_warp_cuda``, f32 and
    bf16."""
    from mnc_tpu_torch.kernels import _roi_warp, plan_roi_warp, roi_warp_cuda

    out_hw, s = ROI_WARP_OUT_HW, ROI_WARP_SCALE
    b, h, w, c = feat32.shape
    for dt in ROI_WARP_TOLERANCES:
        f = feat32.to(dt)
        plan = plan_roi_warp(b, rois.shape[1], c, dt, out_hw, (h, w), band_rows=band_rows)
        banded = _roi_warp("roi_warp", f, rois, out_hw, s, plan)
        if plan.bands < 2 or not torch.equal(banded, roi_warp_cuda(f, rois, out_hw, s)):
            raise AssertionError(f"roi_warp in {plan.bands} bands of {band_rows} rows differs "
                                 f"from one band ({label}, {dt})")
    log(f"kernel A roi_warp {label}: {plan.bands} bands of {band_rows} rows, "
        f"{plan.cell_chunks * 16}-byte cells: bit-equal to one band in f32 and bf16")


def _check_roi_warp(g, c, canvas=CANVAS, b=4, n=304, feat=None, rois=None):
    """Kernel A held (``_hold_roi_warp``) and timed in bf16 beside the plain
    version and ``F.grid_sample``, on random features and boxes of ``canvas``
    (or the given features and rois)."""
    from mnc_tpu_torch.kernels import roi_warp_cuda
    from mnc_tpu_torch.ops.roi_warp import bin_centers, roi_warp_plain
    import torch.nn.functional as F

    out_hw, s = ROI_WARP_OUT_HW, ROI_WARP_SCALE
    if feat is None:
        h, w = canvas[0] // 16, canvas[1] // 16
        feat = torch.randn(b, h, w, c, generator=g, device="cuda")
        rois = torch.stack([random_boxes(g, n, *canvas) for _ in range(b)])
    b, h, w, c = feat.shape
    n = rois.shape[1]
    label = f"B={b} N={n}"
    err, l2 = _hold_roi_warp(feat.float(), rois, label)
    f = feat.to(torch.bfloat16)
    k_ms = cuda_graph_ms(lambda: roi_warp_cuda(f, rois, out_hw, s))
    host_ms = cuda_ms(lambda: roi_warp_cuda(f, rois, out_hw, s))
    p_ms = cuda_ms(lambda: roi_warp_plain(f, rois, out_hw, s), iters=5)
    # the library yardstick: grid_sample over the same bin centers
    yc = bin_centers(rois, out_hw[0], s, 0)  # (B, N, PH)
    xc = bin_centers(rois, out_hw[1], s, 1)  # (B, N, PW)
    gy = (2 * yc + 1) / h - 1
    gx = (2 * xc + 1) / w - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, :, None, :], gy[:, :, :, None]), -1)
    grid = grid.reshape(b, n * out_hw[0], out_hw[1], 2).to(f.dtype)
    fn = f.permute(0, 3, 1, 2).contiguous()
    lib = lambda: F.grid_sample(fn, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                align_corners=False)
    l_ms = cuda_ms(lib)
    lib_err = (lib().reshape(b, c, n, *out_hw).permute(0, 2, 3, 4, 1).float()
               - roi_warp_cuda(f, rois, out_hw, s).float()).abs().max().item()
    out_bytes = b * n * out_hw[0] * out_hw[1] * c * f.element_size()
    bms, by = bound_ms(nbytes(f, rois) + out_bytes, 8.0 * b * n * out_hw[0] * out_hw[1] * c)
    log(f"kernel A roi_warp bf16 B={b} N={n} map {h}x{w} C={c}: kernel_ms {k_ms:.4f} (CUDA "
        f"graph; back to back from the host {host_ms:.4f}) plain_ms {p_ms:.4f} "
        f"library_ms(grid_sample) {l_ms:.4f} (grid_sample vs kernel max diff {lib_err:.3e}); "
        f"bound_ms {bms:.4f} ({by}; {bms / k_ms:.0%} of it)")
    return dict(max_abs_err=err, ms=k_ms, host_paced_ms=host_ms, plain_ms=p_ms, bound_ms=bms,
                bound_by=by, library_ms=l_ms, l2_tap_bytes=l2)


def _bwd_box_sets(g, b, n):
    """The RoI sets kernel A' is held on: the train step's mix, many small
    boxes on the same few cells, and the map's edge cases."""
    mixed = torch.stack([random_boxes(g, n, *CANVAS) for _ in range(b)])
    # boxes whose bin centers are integers (span 14 cells from a cell corner),
    # one of them hanging over the map's edge: the subgradient's tie cases
    mixed[0, 0] = torch.tensor([32.0, 16.0, 255.0, 239.0])
    mixed[1, 0] = torch.tensor([-16.0, 496.0, 207.0, 719.0])
    # 1-12 px boxes with their centers inside one 64 x 64 px patch (4 x 4 cells)
    c = 300.0 + torch.rand(b, n, 2, generator=g, device="cuda") * 64.0
    half = 0.5 + torch.rand(b, n, 2, generator=g, device="cuda") * 5.5
    small = torch.cat([c - half, c + half], -1)
    edge = torch.stack([random_boxes(g, n, *CANVAS) for _ in range(b)])
    h, w = CANVAS
    special = [[0.0, 0.0, w - 1.0, h - 1.0],          # the full canvas: 28 x 28 cells
               [100.0, 100.0, 100.0, 100.0],          # 1 px: every bin on one cell
               [-500.0, -500.0, -300.0, -300.0],      # wholly outside, top left
               [w + 900.0, 100.0, w + 1000.0, 200.0],  # wholly outside, right
               [-40.0, -40.0, 60.0, 60.0],            # over the top-left corner
               [w - 60.0, h - 60.0, w + 40.0, h + 40.0],  # over the far corner
               [-30.0, 200.0, w + 30.0, 215.0]]       # wider than the map, one cell high
    for i, box in enumerate(special):
        edge[i % b, 1 + i // b] = torch.tensor(box)
    return {"mixed 16-500 px": mixed, "small boxes on 4x4 cells": small,
            "full canvas, 1 px, outside": edge}


def check_roi_warp_bwd(g):
    """Kernel A' on the VGG-16 train step's C = 512 (the main row) and the
    ResNet one's C = 1024, each on the three RoI sets."""
    shapes = {"C=512": _check_roi_warp_bwd(g, 512),
              "C=1024": _check_roi_warp_bwd(g, 1024)}
    return dict(shapes["C=512"], shapes=shapes)


def _hold_bwd_lists(rois, out_hw, s, map_hw, ints, label):
    """Kernel A′'s tile lists and plan, read from its scratch, against their
    plain twins (``roi_warp_bwd_lists``, ``roi_warp_bwd_plan``): equal."""
    from mnc_tpu_torch.kernels import (roi_warp_bwd_lists, roi_warp_bwd_plan,
                                       roi_warp_bwd_read_lists)

    b, n = rois.shape[:2]
    counts, lists, splits, base = roi_warp_bwd_read_lists(ints, b, n, map_hw)
    want_counts, want_lists = roi_warp_bwd_lists(rois, out_hw, s, map_hw)
    want_splits, want_base = roi_warp_bwd_plan(want_counts)
    same = (torch.equal(counts, want_counts) and torch.equal(lists, want_lists)
            and torch.equal(splits, want_splits) and torch.equal(base, want_base))
    log(f"kernel A' roi_warp_bwd {label}: tile lists equal to the plain twin's {same} "
        f"({counts.numel()} tiles, {int(counts.sum())} entries, longest {int(counts.max())}; "
        f"{int(splits.sum())} units, {int((splits > 1).sum())} tiles split)")
    if not same:
        raise AssertionError(f"roi_warp_bwd: the tile lists or the plan differ from the "
                             f"plain twins ({label})")


def _check_roi_warp_bwd(g, c):
    """Kernel A' against autograd through roi_warp_plain at the train step's
    shapes, on the three RoI sets.  f32: tight.  bf16: tight against the f32
    plain gradient of the same bf16-valued inputs (the kernel accumulates in
    f32 and rounds once), loose against the bf16 plain gradient (which, like
    JAX's, runs through bf16-rounded hats and a bf16 intermediate).  Its tile
    lists and plan must equal their plain twins', and dF and d rois must be
    bit-equal between two runs."""
    from mnc_tpu_torch.kernels import _roi_warp_bwd, roi_warp_bwd_cuda
    from mnc_tpu_torch.ops.roi_warp import bin_centers, roi_warp_plain
    import torch.nn.functional as F

    b, n, (h, w), out_hw, s = 2, 128, (40, 64), (14, 14), 1.0 / 16
    feat32 = torch.randn(b, h, w, c, generator=g, device="cuda")
    gout32 = torch.randn(b, n, *out_hw, c, generator=g, device="cuda")
    f, go = feat32.to(torch.bfloat16), gout32.to(torch.bfloat16)
    sets = _bwd_box_sets(g, b, n)

    def plain_grads(rois, f, go):
        fp, rp = f.clone().requires_grad_(), rois.clone().requires_grad_()
        return torch.autograd.grad(roi_warp_plain(fp, rp, out_hw, s), (fp, rp), go)

    def compare(label, got, want, tol_f, tol_r):
        errs = []
        for name, a, e, tol in (("dF", got[0], want[0], tol_f), ("drois", got[1], want[1], tol_r)):
            err = (a.float() - e.float()).abs().max().item()
            lim = tol * e.float().abs().max().item()
            log(f"kernel A' roi_warp_bwd C={c} {label} {name}: max_abs_err {err:.3e} "
                f"(tolerance {lim:.3e})")
            if not err <= lim:
                raise AssertionError(f"roi_warp_bwd {name} disagrees with the plain "
                                     f"gradient ({label})")
            errs.append(err)
        return errs

    err16, set_ms = {}, {}
    for label, rois in sets.items():
        *got32, ints = _roi_warp_bwd(gout32, feat32, rois, s, keep_scratch=True)
        _hold_bwd_lists(rois, out_hw, s, (h, w), ints, f"C={c} [{label}]")
        compare(f"[{label}] f32", got32, plain_grads(rois, feat32, gout32), 1e-5, 1e-4)
        got16 = roi_warp_bwd_cuda(go, f, rois, s)
        # one rounding to bf16 of an f32-accurate sum: at most half an ulp, 2^-8
        # of the value, plus the f32 sums' own 1e-5
        err16[label] = compare(f"[{label}] bf16 vs f32 plain", got16,
                               plain_grads(rois, f.float(), go.float()),
                               2.0 ** -8 + 1e-5, 1e-4)[0]
        compare(f"[{label}] bf16 vs bf16 plain", got16, plain_grads(rois, f, go),
                2.0 ** -5, 0.05)
        for dt_label, args in (("f32", (gout32, feat32)), ("bf16", (go, f))):
            again = roi_warp_bwd_cuda(*args, rois, s)
            first = got32 if dt_label == "f32" else got16
            for name, x, y in (("dF", again[0], first[0]), ("d rois", again[1], first[1])):
                if not torch.equal(x, y):
                    raise AssertionError(f"roi_warp_bwd: {name} differs between two runs "
                                         f"({label}, {dt_label}, C={c}): "
                                         f"{int((x != y).sum())} elements")
        set_ms[label] = cuda_ms(lambda: roi_warp_bwd_cuda(go, f, rois, s))
        log(f"kernel A' roi_warp_bwd C={c} [{label}]: dF and d rois bit-equal between two "
            f"runs in f32 and bf16; bf16 kernel_ms {set_ms[label]:.4f}")

    main = "mixed 16-500 px"
    rois = sets[main]
    k_ms = set_ms[main]
    fp, rp = f.clone().requires_grad_(), rois.clone().requires_grad_()
    out = roi_warp_plain(fp, rp, out_hw, s)
    p_ms = cuda_ms(lambda: torch.autograd.grad(out, (fp, rp), go, retain_graph=True),
                   iters=5, warmup=1)
    # the library yardstick: grid_sample's backward (features and grid)
    yc, xc = bin_centers(rois, out_hw[0], s, 0), bin_centers(rois, out_hw[1], s, 1)
    gy, gx = (2 * yc + 1) / h - 1, (2 * xc + 1) / w - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, :, None, :], gy[:, :, :, None]), -1)
    grid = grid.reshape(b, n * out_hw[0], out_hw[1], 2).to(f.dtype).requires_grad_()
    fn = f.permute(0, 3, 1, 2).contiguous().requires_grad_()
    lib_out = F.grid_sample(fn, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
    lib_go = go.reshape(b, n * out_hw[0], out_hw[1], c).permute(0, 3, 1, 2).contiguous()
    l_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (fn, grid), lib_go,
                                               retain_graph=True))
    log(f"kernel A' roi_warp_bwd bf16 B={b} N={n} C={c}: kernel_ms {k_ms:.4f} "
        f"plain_ms {p_ms:.4f} "
        f"library_ms(grid_sample backward) {l_ms:.4f}")
    # reads g, the features and the rois; writes d features and d rois
    bms, by = bound_ms(nbytes(go, f, rois) + nbytes(f, rois),
                       16.0 * b * n * out_hw[0] * out_hw[1] * c)
    return dict(max_abs_err=err16[main], ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                library_ms=l_ms, ms_by_box_set=set_ms)


# kernel D's input on a rank of the spatial trunk (phase 4k): its rows of a 640x1024
# canvas and two rows of each inner neighbour, at an edge rank of 2 or a middle rank
SPATIAL_SLABS = {"edge": (1, 322, 1024, 3), "middle": (1, 324, 1024, 3)}


def check_block1(g):
    """Kernel D against block1_plain: only the order of the f32 sums may
    differ, so at least 0.999 of the elements must be bit-identical and every
    element within block1_tolerance (one bf16 ulp of the value before the
    bias add, plus the echo of a conv1_1 output that rounded the other way);
    the border rows and columns are held on their own; at the full canvas, at
    a small shape whose tiles hang over the edges and on a constant image.
    Also at the slabs of the spatial trunk (``SPATIAL_SLABS``: a rank's 320
    rows of a 640x1024 canvas and two rows of halo on one side, or four on
    both).  Then timed at the train step's B = 2, the serving request's B = 4
    and both slabs."""
    from mnc_tpu_torch.ops.block1 import (block1_plain, block1_tolerance, conv_relu_plain,
                                          fused_block1)
    import torch.nn.functional as F

    w1 = torch.randn(64, 3, 3, 3, generator=g, device="cuda") * 0.1
    b1 = torch.randn(64, generator=g, device="cuda")
    w2 = torch.randn(64, 64, 3, 3, generator=g, device="cuda") * 0.05
    b2 = torch.randn(64, generator=g, device="cuda")
    worst = 0.0
    for label, shape, const in (("full canvas", (2, *CANVAS, 3), None),
                                ("ragged tiles", (3, 40, 50, 3), None),
                                ("constant image", (1, 24, 18, 3), 7.0),
                                ("spatial edge slab", SPATIAL_SLABS["edge"], None),
                                ("spatial middle slab", SPATIAL_SLABS["middle"], None)):
        x = (torch.randn(shape, generator=g, device="cuda") * 50 if const is None
             else torch.full(shape, const, device="cuda"))
        got = fused_block1(x, w1, b1, w2, b2).float()
        want = block1_plain(x, w1, b1, w2, b2).float()
        if got.shape != want.shape:
            raise AssertionError(f"block1 {label}: shape {tuple(got.shape)}")
        o1_max = conv_relu_plain(x.to(torch.bfloat16).permute(0, 3, 1, 2), w1,
                                 b1).float().max().item()
        over = (got - want).abs() - block1_tolerance(want, o1_max, w2, b2)
        edge = torch.cat([over[:, 0].flatten(), over[:, -1].flatten(),
                          over[:, :, 0].flatten(), over[:, :, -1].flatten()])
        err = (got - want).abs().max().item()
        exact = (got == want).float().mean().item()
        log(f"kernel D block1 {label} {tuple(shape)}: max_abs_err {err:.3e}, "
            f"{exact:.6f} of the elements bit-identical (must be >= 0.999), worst excess "
            f"over the tolerance {over.max().item():.3e} (border {edge.max().item():.3e}; "
            f"must be <= 0)")
        if over.max().item() > 0 or exact < 0.999:
            raise AssertionError(f"block1 kernel disagrees with its plain version ({label})")
        if label == "full canvas":
            worst = err
    # timed at the train step's B = 2 and the serving request's B = 4
    bf = torch.bfloat16
    cw1, cw2 = (t.to(bf).contiguous(memory_format=torch.channels_last) for t in (w1, w2))
    cb1, cb2 = b1.to(bf), b2.to(bf)
    w_bytes = (27 * 64 + 576 * 64 + 128) * 2
    shapes = {}
    timed = [(f"B={bsz}", (bsz, *CANVAS)) for bsz in (2, 4)]
    timed += [(f"{k} slab", v[:3]) for k, v in SPATIAL_SLABS.items()]
    for label, (bsz, hh, ww) in timed:
        x = torch.randn(bsz, hh, ww, 3, generator=g, device="cuda") * 50
        k_ms = cuda_ms(lambda: fused_block1(x, w1, b1, w2, b2), iters=10)
        p_ms = cuda_ms(lambda: block1_plain(x, w1, b1, w2, b2), iters=3, warmup=1)
        # the library yardstick: the trunk's unfused block 1 (cuDNN, bf16, channels-last)
        xn = x.to(bf).permute(0, 3, 1, 2)

        def unfused():
            y = F.relu(F.conv2d(xn, cw1, cb1, padding=1))
            return F.max_pool2d(F.relu(F.conv2d(y, cw2, cb2, padding=1)), 2, 2)

        l_ms = cuda_ms(unfused, iters=10)
        lib_diff = (unfused().permute(0, 2, 3, 1).float()
                    - fused_block1(x, w1, b1, w2, b2).float()).abs().max().item()
        out_bytes = bsz * (hh // 2) * (ww // 2) * 64 * 2
        bms, by = bound_ms(bsz * hh * ww * 3 * 2 + w_bytes + out_bytes,
                           2.0 * bsz * hh * ww * 64 * (27 + 576), BF16_FLOP_PER_S)
        log(f"kernel D block1 {label} {(bsz, hh, ww, 3)}: kernel_ms {k_ms:.4f} plain_ms "
            f"{p_ms:.4f} library_ms(unfused cuDNN block) {l_ms:.4f} (unfused vs kernel max "
            f"diff {lib_diff:.3e}) bound_ms {bms:.4f} ({by}, {bms / k_ms:.0%} of it)")
        shapes[label] = dict(shape=[bsz, hh, ww, 3], ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                             bound_ms=bms, bound_by=by)
        del x, xn
    main = shapes["B=2"]
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shapes=shapes)


def _nms_case(g, p, k, cluster, invalid_frac, trailing):
    """Score-sorted boxes with exact score ties and invalid padding."""
    centers = random_boxes(g, p * cluster, *CANVAS, lo=24.0, hi=300.0).reshape(p, cluster, 4)
    pick = torch.randint(0, cluster, (p, k), generator=g, device="cuda")
    base = torch.gather(centers, 1, pick[..., None].expand(p, k, 4))
    jitter = (torch.rand(p, k, 4, generator=g, device="cuda") - 0.5) * 40.0
    boxes = base + jitter
    boxes[..., 2:] = torch.maximum(boxes[..., 2:], boxes[..., :2] + 1.0)
    u = torch.rand(p, k, generator=g, device="cuda")
    if trailing:  # the proposal layout: valid first, padding at the end
        n_valid = int(k * (1 - invalid_frac))
        valid = torch.arange(k, device="cuda").expand(p, k) < n_valid
    else:
        valid = u > invalid_frac
    scores = torch.round(torch.rand(p, k, generator=g, device="cuda") * 64) / 64  # ties
    return boxes.contiguous(), valid.contiguous(), scores


def _nms_stop(keep, top_n):
    """(P,) index of the box at which each problem's scan stops."""
    p, k = keep.shape
    if top_n > 0:
        return torch.where(keep.sum(1) >= top_n,
                           (keep.cumsum(1) >= top_n).float().argmax(1), k - 1)
    return torch.full((p,), k - 1, device=keep.device)


def _nms_bound(boxes, valid, keep, top_n):
    """Bytes and the IoU work this data needs: each kept box i is compared
    with every box after it up to where the scan stops."""
    k = keep.shape[1]
    ar = torch.arange(k, device=keep.device)
    stop = _nms_stop(keep, top_n)
    pairs = ((stop[:, None] - ar) * keep).clamp_min(0).sum().item()
    return bound_ms(nbytes(boxes, valid, keep), 16.0 * pairs)


NMS_SHAPES = {  # label: (P, K, thresh, top_n, invalid boxes trailing)
    "proposal": (4, 6000, 0.7, 304, True),
    "per-class": (80, 304, 0.3, 0, False),
    "per-class, 81 classes": (320, 304, 0.3, 0, False),  # 4 canvases x 80 COCO classes
    "per-class, CFM 20 x 300": (20, 300, 0.3, 0, False),  # cfm_detect: 1 image, 300 segments
    "train proposal": (2, 12000, 0.7, 2000, True)}


def nms_step_latency_ms(p, k):
    """The micro-check behind kernel B's latency floor: P problems of K
    identical boxes.  Box 0 is kept and suppresses all others, so the scan
    walks every chunk of 64 and each chunk is one dependent step with next
    to no IoU work.  Returns (ms per chunk, chunks)."""
    from mnc_tpu_torch.kernels import nms_keep_cuda

    boxes = torch.tensor([10.0, 10.0, 50.0, 50.0], device="cuda").expand(p, k, 4).contiguous()
    valid = torch.ones(p, k, dtype=torch.bool, device="cuda")
    keep = nms_keep_cuda(boxes, valid, 0.5, 0)
    if not (keep[:, 0].all() and int(keep.sum()) == p):
        raise AssertionError("nms kernel: identical boxes must leave one keep per problem")
    chunks = -(-k // 64)
    return cuda_ms(lambda: nms_keep_cuda(boxes, valid, 0.5, 0)) / chunks, chunks


def _nms_adversarial(g):
    """(label, boxes (P, K, 4), valid (P, K), thresh, top_ns) at full K: what
    a chunked scan gets wrong first."""
    dev = "cuda"
    cases = []
    for k in (12000, 6001, 304):
        # chain: box i suppresses only box i + 1 (IoU 81/121, two apart 61/141):
        # keeps alternate across every chunk border, each diagonal tile needs
        # as many rounds as it is long; an invalid box breaks the chain
        x = 20.0 * torch.arange(k, device=dev, dtype=torch.float32)
        chain = torch.stack([x, torch.zeros_like(x), x + 100.0, torch.full_like(x, 100.0)], -1)
        valid = torch.ones(2, k, dtype=torch.bool, device=dev)
        valid[1, 64] = valid[1, 191] = False
        cases.append((f"chain K={k}", chain.expand(2, k, 4).contiguous(), valid, 0.5,
                      (0, 33)))
        # disjoint boxes: every valid box is a keep, so the stop falls where
        # top_n says: last box of a chunk (64, 128), first (65, 129), middle,
        # the very last box, and never
        grid = torch.stack([150.0 * (torch.arange(k, device=dev) % 100),
                            150.0 * (torch.arange(k, device=dev) // 100)], -1).float()
        disjoint = torch.cat([grid, grid + 99.0], -1)[None].contiguous()
        cases.append((f"disjoint K={k}", disjoint,
                      torch.ones(1, k, dtype=torch.bool, device=dev), 0.7,
                      (0, 1, 64, 65, 100, 128, 129, k - 1, k, k + 7)))
        # the same with every third box invalid: the count skips them
        cases.append((f"disjoint, every third invalid K={k}", disjoint,
                      (torch.arange(k, device=dev) % 3 != 1)[None].contiguous(), 0.7,
                      (0, 43, 44, 64, 86)))
        # clustered boxes, invalid ones interleaved (the per-class layout at
        # full K) and trailing, heavy suppression at a low threshold
        for trailing in (False, True):
            boxes, valid, _ = _nms_case(g, 2, k, cluster=max(k // 40, 4), invalid_frac=0.3,
                                        trailing=trailing)
            cases.append((f"clustered, invalid {'trailing' if trailing else 'interleaved'} "
                          f"K={k}", boxes, valid, 0.3, (0, 63, 64, 65)))
        dup = torch.tensor([10.0, 10.0, 50.0, 50.0], device=dev).expand(2, k, 4).contiguous()
        valid = torch.ones(2, k, dtype=torch.bool, device=dev)
        valid[1] = False
        cases.append((f"identical boxes / all invalid K={k}", dup, valid, 0.5, (0, 1, 5)))
    return cases


def check_nms(g):
    """Kernel B: keeps identical to nms_keep_plain at the three shapes of the
    main paths and at the adversarial cases, with top_n and with the scan run
    to its end; nms_indices on the card equal to the CPU with tied scores;
    then time, bound and latency floor per shape."""
    from mnc_tpu_torch.kernels import nms_keep_cuda
    from mnc_tpu_torch.ops.nms import nms_indices, nms_keep_plain

    for label, boxes, valid, thresh, top_ns in _nms_adversarial(g):
        kept = []
        for tn in top_ns:
            got = nms_keep_cuda(boxes, valid, thresh, tn)
            if not torch.equal(got, nms_keep_plain(boxes, valid, thresh, tn)):
                raise AssertionError(f"nms kernel keeps differ ({label}, top_n={tn})")
            kept.append(int(got.sum()))
        log(f"kernel B nms {label} P={boxes.shape[0]} thresh={thresh}: keeps identical for "
            f"top_n {top_ns} ({kept} kept)")

    shapes = {}
    for label, (p, k, thresh, top_n, trailing) in NMS_SHAPES.items():
        boxes, valid, scores = _nms_case(g, p, k, cluster=max(k // 20, 4),
                                         invalid_frac=0.2, trailing=trailing)
        for tn in sorted({top_n, 0}):
            got = nms_keep_cuda(boxes, valid, thresh, tn)
            want = nms_keep_plain(boxes, valid, thresh, tn)
            if not torch.equal(got, want):
                raise AssertionError(f"nms kernel keeps differ ({label}, top_n={tn})")
            log(f"kernel B nms {label} P={p} K={k} thresh={thresh} top_n={tn}: "
                f"keeps identical ({int(got.sum())} kept)")
        # through nms_indices with tied, unsorted scores: CUDA (kernel) vs CPU (plain)
        chunk = 256 if top_n else None
        n_out = top_n or 64
        gi = nms_indices(boxes, scores, valid, thresh, n_out, chunk=chunk)
        ci = nms_indices(boxes.cpu(), scores.cpu(), valid.cpu(), thresh, n_out, chunk=chunk)
        if not (torch.equal(gi[0].cpu(), ci[0]) and torch.equal(gi[1].cpu(), ci[1])):
            raise AssertionError(f"nms_indices on the card differs from the CPU ({label})")
        log(f"kernel B nms_indices {label} with score ties: selections identical to the CPU")
        keep = nms_keep_cuda(boxes, valid, thresh, top_n)
        k_ms = cuda_ms(lambda: nms_keep_cuda(boxes, valid, thresh, top_n))
        p_ms = cuda_ms(lambda: nms_keep_plain(boxes, valid, thresh, top_n), iters=3,
                       warmup=1)
        bms, by = _nms_bound(boxes, valid, keep, top_n)
        # the scan's latency floor: the chunks of 64 this data makes the longest
        # problem walk, times one dependent step as the micro-check measures it
        step_ms, all_chunks = nms_step_latency_ms(p, k)
        chunks = int(_nms_stop(keep, top_n).max()) // 64 + 1
        floor_ms = chunks * step_ms
        log(f"kernel B nms {label}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {bms:.5f} ({by}); latency floor {floor_ms:.4f} ms = {chunks} of "
            f"{all_chunks} chunks x {step_ms * 1e3:.3f} us per dependent step")
        shapes[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by, chunks=chunks,
                             step_us=step_ms * 1e3, latency_floor_ms=floor_ms)
    total = {key: sum(v[key] for v in shapes.values()) for key in ("ms", "plain_ms", "bound_ms")}
    by = "operations" if any(v["bound_by"] == "operations" for v in shapes.values()) else "bytes"
    return dict(max_abs_err=0.0, **total, bound_by=by, library_ms=None, shapes=shapes)


# label: (detections N, canvas, mask size M); M = 28 is what a caffemodel's
# auto-config gives (the detect_many path below), on both canvases
PASTE_SHAPES = {"serving request": (400, CANVAS, 21), "N=100": (100, CANVAS, 21),
                "M=28": (400, CANVAS, 28), "M=28, portrait 1024x640": (400, PORTRAIT, 28),
                "cfm_detect N=100": (100, CANVAS, 21)}  # one image's MAX_PER_IMAGE


def _paste_inputs(g, boxes, h, w, m=21):
    """Kernel C's operands for (N, 4) boxes: wy (N, H, M), masks, wxt (N, M,
    W) and wx (N, W, M)."""
    from mnc_tpu_torch.ops.masks import _paste_axis_weights

    masks = torch.sigmoid(2 * torch.randn(boxes.shape[0], m, m, generator=g, device="cuda"))
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], m, h).contiguous()
    wx = _paste_axis_weights(boxes[:, 0], boxes[:, 2], m, w)
    return wy, masks, wx.transpose(1, 2).contiguous(), wx


def _paste_edge_boxes(g, h, w):
    """Boxes wholly outside the canvas, of 1 px, over the full canvas and
    beyond it, on its edges, and a few random ones."""
    special = [[-500.0, -500.0, -300.0, -300.0], [w + 100.0, 10.0, w + 300.0, 200.0],
               [10.0, h + 50.0, 200.0, h + 300.0], [-90.0, 30.0, -1.0, 80.0],
               [100.0, 100.0, 100.0, 100.0], [300.5, 200.25, 300.5, 200.25],
               [0.0, 0.0, 0.0, 0.0], [w - 1.0, h - 1.0, w - 1.0, h - 1.0],
               [0.0, 0.0, w - 1.0, h - 1.0], [-40.0, -40.0, w + 40.0, h + 40.0],
               [-20.0, 5.0, 7.0, 30.0], [w - 9.0, h - 17.0, w + 30.0, h + 2.0],
               [15.0, 0.0, 17.0, h - 1.0], [0.0, 31.0, w - 1.0, 33.0]]
    boxes = torch.tensor(special, device="cuda")
    return torch.cat([boxes, random_boxes(g, 18, h, w, lo=1.0, hi=40.0)])


def _paste_agrees(label, got, wy, masks, wxt, thresh):
    """Every pixel equal to the f32 product's binarization, except within 1e-5
    of the threshold (the order of the f32 sums differs); returns that worst
    |product - threshold| of a differing pixel."""
    prod = torch.bmm(torch.bmm(wy, masks), wxt)
    mism = got != (prod > thresh)
    worst = (prod[mism] - thresh).abs().max().item() if mism.any() else 0.0
    outside = ~((wy != 0).any(-1)[:, :, None] & (wxt != 0).any(-2)[:, None, :])
    const_ok = bool((got[outside] == (0.0 > thresh)).all())
    log(f"kernel C paste {label} N={wy.shape[0]} {wy.shape[1]}x{wxt.shape[2]} "
        f"thresh={thresh}: {int(mism.sum())} pixels differ from the f32 product, all within "
        f"{worst:.2e} of the threshold (tolerance 1e-5); pixels outside the box "
        f"{'all' if const_ok else 'NOT all'} {0.0 > thresh}")
    if worst > 1e-5 or not const_ok:
        raise AssertionError(f"paste kernel disagrees with its plain version ({label})")
    return worst


def check_paste(g):
    """Kernel C against the f32 product: the serving request's N = 400 and
    N = 100 at 640x1024, M = 28 on both canvases, then edge boxes with a
    positive and a negative threshold (also at M = 28 on the portrait
    canvas) and a canvas width that is not a multiple of 16; time, plain
    and library time and byte bound per shape."""
    from mnc_tpu_torch.kernels import paste_binarize_cuda
    from mnc_tpu_torch.ops.masks import paste_binarize_plain

    thresh = 0.4
    for label, (hh, ww), m in (("edge boxes", CANVAS, 21),
                               ("edge boxes M=28, portrait", PORTRAIT, 28),
                               ("W % 16 != 0", (97, 203), 21)):
        ins = _paste_inputs(g, _paste_edge_boxes(g, hh, ww), hh, ww, m)[:3]
        for t in (thresh, -0.1):
            _paste_agrees(label, paste_binarize_cuda(*ins, t), *ins, t)
    shapes, worst = {}, 0.0
    for label, (n, (h, w), m) in PASTE_SHAPES.items():
        wy, masks, wxt, wx = _paste_inputs(g, random_boxes(g, n, h, w, lo=20.0, hi=500.0),
                                           h, w, m)
        got = paste_binarize_cuda(wy, masks, wxt, thresh)
        worst = max(worst, _paste_agrees(label, got, wy, masks, wxt, thresh))
        del got
        k_ms = cuda_ms(lambda: paste_binarize_cuda(wy, masks, wxt, thresh))
        p_ms = cuda_ms(lambda: paste_binarize_plain(wy, masks, wxt, thresh), iters=5)
        l_ms = cuda_ms(lambda: torch.einsum("nhp,npq,nwq->nhw", wy, masks, wx) > thresh,
                       iters=5)
        rows = (wy != 0).any(-1).sum(-1).double()  # canvas rows inside each box
        cols = (wxt != 0).any(-2).sum(-1).double()
        flops = (2.0 * m * m * rows + 2.0 * m * rows * cols).sum().item()
        bms, by = bound_ms(nbytes(wy, masks, wxt) + n * h * w, flops)
        log(f"kernel C paste {label} N={n} {h}x{w} M={m}: kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} "
            f"library_ms(einsum) {l_ms:.4f} bound_ms {bms:.4f} ({by}, "
            f"{bms / k_ms:.0%} of it)")
        shapes[label] = dict(n=n, canvas=[h, w], m=m, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                             bound_ms=bms, bound_by=by)
    main = shapes["serving request"]
    # for a bool output: the largest |product - threshold| of a differing pixel
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shapes=shapes)


INT8_OP_PER_S = 1979e12  # H100 SXM data sheet, dense int8 on the tensor cores
# kernel E's shapes on the int8 serving paths: label -> (kind, x shape, Cout, k, stride,
# pad, bias, out dtype).  Convolutions take NHWC x; dense layers (M, K).  VGG-16 and
# ResNet-101 at a request of 4 640x1024 canvases, 304 RoIs each (M = 1216), cfm_detect's
# 300 segments of one image, and a small f32 model's odd sizes.
BF, F32 = torch.bfloat16, torch.float32
GEMM_S8_SHAPES = {
    "vgg conv1_1 (K=27)": ("conv", (4, *CANVAS, 3), 64, 3, 1, 1, True, BF),
    "vgg conv1_2": ("conv", (4, *CANVAS, 64), 64, 3, 1, 1, True, BF),
    "vgg conv2_1": ("conv", (4, 320, 512, 64), 128, 3, 1, 1, True, BF),
    "vgg conv3_2": ("conv", (4, 160, 256, 256), 256, 3, 1, 1, True, BF),
    "vgg conv4_2": ("conv", (4, 80, 128, 512), 512, 3, 1, 1, True, BF),
    "vgg conv5_2 (40x64)": ("conv", (4, 40, 64, 512), 512, 3, 1, 1, True, BF),
    "vgg conv5_2 portrait (64x40)": ("conv", (4, 64, 40, 512), 512, 3, 1, 1, True, BF),
    "fc6 (M=1216)": ("dense", (1216, 25088), 4096, 1, 1, 0, True, BF),
    "fc7 (M=1216)": ("dense", (1216, 4096), 4096, 1, 1, 0, True, BF),
    "fc_mask (M=1216)": ("dense", (1216, 100352), 256, 1, 1, 0, True, BF),
    "fc6 cfm (M=300)": ("dense", (300, 25088), 4096, 1, 1, 0, True, BF),
    "resnet stem 7x7/s2 (K=147)": ("conv", (4, *CANVAS, 3), 64, 7, 2, 3, False, BF),
    "resnet 1x1 stage2": ("conv", (4, 160, 256, 256), 64, 1, 1, 0, False, BF),
    "resnet 1x1/s2 proj stage3": ("conv", (4, 160, 256, 256), 512, 1, 2, 0, False, BF),
    "resnet 3x3/s2 v1.5 stage4": ("conv", (4, 80, 128, 256), 256, 3, 2, 1, False, BF),
    "resnet 3x3 stage4 (40x64)": ("conv", (4, 40, 64, 256), 256, 3, 1, 1, False, BF),
    "resnet 1x1 stage4 1024->256 (40x64)": ("conv", (4, 40, 64, 1024), 256, 1, 1, 0, False,
                                            BF),
    "resnet 1x1 stage4 256->1024 (40x64)": ("conv", (4, 40, 64, 256), 1024, 1, 1, 0, False,
                                            BF),
    "conv5 head 1x1/s2 proj (14->7)": ("conv", (1216, 14, 14, 1024), 2048, 1, 2, 0, False, BF),
    "conv5 head 3x3 (7x7)": ("conv", (1216, 7, 7, 512), 512, 3, 1, 1, False, BF),
    "small f32 conv (odd Cout)": ("conv", (2, 13, 17, 24), 21, 3, 1, 1, True, F32),
    "small f32 dense (K=300)": ("dense", (37, 300), 40, 1, 1, 0, True, F32),
}


def _gemm_s8_inputs(g, kind, shape, cout, k, bias, dtype):
    """Quantized operands as the int8 layers make them: activations after a
    ReLU in the compute dtype (quant_act), f32 weights (quant_weight)."""
    from mnc_tpu_torch.ops.quant import quant_act, quant_weight

    x = torch.relu(torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    cin = shape[-1]
    wshape = (cout, cin, k, k) if kind == "conv" else (cout, cin)
    w = torch.randn(wshape, generator=g, device="cuda") * 0.05
    xq, xs = quant_act(x, per_row=kind == "dense")
    wq, ws = quant_weight(w)
    b = torch.randn(cout, generator=g, device="cuda") if bias else None
    return x, w, xq.contiguous(), xs, wq, ws, b


def _extreme(g, t):
    """An int8 tensor of t's shape holding only -127 and 127."""
    s = torch.randint(0, 2, t.shape, generator=g, device=t.device, dtype=torch.int16)
    return (s * 254 - 127).to(torch.int8)


def _plain_ms(fn):
    """(result, device ms) of one call of fn, between CUDA events."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def check_gemm_s8(g):
    """Kernel E against gemm_s8_plain (float64 sums of the int8 values, exact)
    at every shape of the int8 serving paths, on random and on all-+-127
    operands: the outputs must be bit-identical.  The weights are packed
    once (pack_gemm_s8_weight), as the int8 layers cache them.  Timed per
    shape beside the plain version, the bound, and the library: where E's
    product is one matrix product (dense layers, 1x1 stride-1 convolutions
    on their (M, C) view) torch._int_mm and the same dequantization (the same
    function); for any other convolution there is no int8 convolution in
    PyTorch on CUDA, so library_ms is null and the float path's bf16 cuDNN
    convolution of the same shape is given beside it (another function)."""
    import torch.nn.functional as F
    from mnc_tpu_torch import kernels
    from mnc_tpu_torch.ops.quant import dequantize, gemm_s8_plain

    shapes = {}
    for label, (kind, shape, cout, k, stride, pad, bias, dtype) in GEMM_S8_SHAPES.items():
        x, w, xq, xs, wq, ws, b = _gemm_s8_inputs(g, kind, shape, cout, k, bias, dtype)
        args = (stride, pad, dtype) if kind == "conv" else (1, 0, dtype)
        wp = kernels.pack_gemm_s8_weight(wq)
        got = kernels.gemm_s8_cuda(xq, wq, xs, ws, b, *args, wp)
        want, p_ms = _plain_ms(lambda: gemm_s8_plain(xq, wq, xs, ws, b, *args))
        diff = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        del want
        xe, we = _extreme(g, xq), _extreme(g, wq)
        e_got = kernels.gemm_s8_cuda(xe, we, xs, ws, b, *args, kernels.pack_gemm_s8_weight(we))
        e_want = gemm_s8_plain(xe, we, xs, ws, b, *args)
        e_same = torch.equal(e_got, e_want)
        same = same and e_same
        diff = max(diff, (e_got.float() - e_want.float()).abs().max().item())
        del xe, we, e_got, e_want
        m = got.numel() // cout
        kk = xq.shape[-1] * (k * k if kind == "conv" else 1)
        c = xq.shape[-1]
        if kind == "conv":
            oh, ow = got.shape[1:3]
            plan = kernels.plan_gemm_s8(m, cout, kk, c=c, kh=k, kw=k, stride=stride, pad=pad,
                                        ow=ow, conv=True, aligned=xq.data_ptr() % 16 == 0)
        else:
            plan = kernels.plan_gemm_s8(m, cout, kk, c=c, kh=1, kw=1, stride=1, pad=0, ow=1,
                                        conv=False, aligned=xq.data_ptr() % 16 == 0)
        k_ms = cuda_ms(lambda: kernels.gemm_s8_cuda(xq, wq, xs, ws, b, *args, wp), iters=10)
        n_bytes = nbytes(xq, wq, xs, ws, got) + (nbytes(b) if b is not None else 0)
        bms, by = bound_ms(n_bytes, 2.0 * m * cout * kk, INT8_OP_PER_S)
        row = dict(kind=kind, x=list(shape), cout=cout, k=k, stride=stride, pad=pad,
                   gmac=m * cout * kk / 1e9, plan=f"{plan.mode} bn{plan.bn} split{plan.splits}",
                   ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by, bit_identical=same,
                   max_abs_err=diff)
        one_mm = kind == "dense" or (k == 1 and stride == 1 and pad == 0)
        # torch._int_mm takes M > 16 and K, N multiples of 8
        if one_mm and m > 16 and kk % 8 == 0 and cout % 8 == 0:
            a2, w2 = xq.view(m, kk), wq.view(cout, kk)

            def int_mm():
                return dequantize(torch._int_mm(a2, w2.t()), xs, ws, b, dtype).view(got.shape)

            lib_same = torch.equal(int_mm(), got)
            row.update(library_ms=cuda_ms(int_mm, iters=10), library_bit_identical=lib_same)
            lib = f"library_ms(torch._int_mm + dequantize) {row['library_ms']:.4f} " \
                  f"(bit-identical {lib_same})"
        elif one_mm:
            row.update(library_ms=None)
            lib = "library_ms null (torch._int_mm refuses K or N not a multiple of 8)"
        else:
            xn = x.permute(0, 3, 1, 2)
            wf = w.to(dtype).contiguous(memory_format=torch.channels_last)
            bf = None if b is None else b.to(dtype)
            row.update(library_ms=None, float_path_ms=cuda_ms(
                lambda: F.conv2d(xn, wf, bf, stride, pad), iters=10))
            lib = f"library_ms null (no int8 conv in PyTorch); float path ({dtype} cuDNN " \
                  f"conv, another function) {row['float_path_ms']:.4f}"
        log(f"kernel E gemm_s8 {label} {kind} x{tuple(shape)} -> {cout} (k {k}, s {stride}, "
            f"p {pad}, {dtype}; plan {row['plan']}): bit-identical to the plain version on "
            f"random and all +-127 operands {same} (max_abs_err {diff:.3e}); kernel_ms "
            f"{k_ms:.4f} plain_ms(f64) {p_ms:.4f} {lib} bound_ms {bms:.4f} ({by}, "
            f"{bms / k_ms:.0%} of it; {row['gmac']:.2f} GMAC)")
        shapes[label] = row
        del x, w, xq, wq, wp, got
        if not same:
            raise AssertionError(f"gemm_s8 kernel differs from its plain version ({label})")
    torch.cuda.empty_cache()
    main = shapes["vgg conv1_2"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in shapes.values()), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"], shapes=shapes)


# (input shape, per_row) of every int8 layer of one request of 4 canvases (304 RoIs each)
# on phase 4a's VGG-16 and the ResNet-101 COCO configuration with either head;
# int8_layer_inputs finds them on the card and checks them against this list
INT8_LAYER_INPUTS = (
    ((4, 640, 1024, 3), False), ((4, 640, 1024, 64), False), ((4, 320, 512, 64), False),
    ((4, 320, 512, 128), False), ((4, 160, 256, 128), False), ((4, 160, 256, 256), False),
    ((4, 80, 128, 256), False), ((4, 80, 128, 512), False), ((4, 40, 64, 512), False),
    ((1216, 100352), True), ((1216, 25088), True), ((1216, 4096), True),  # VGG-16
    ((4, 160, 256, 64), False), ((4, 80, 128, 128), False), ((4, 40, 64, 256), False),
    ((4, 40, 64, 1024), False),  # ResNet-101 trunk (the stem's input is conv1_1's)
    ((1216, 14, 14, 1024), False), ((1216, 7, 7, 512), False), ((1216, 7, 7, 2048), False),
    ((1216, 200704), True),  # the conv5 head and the ResNet mask head
    ((1216, 50176), True),  # the fc head's fc6 (its fc7 input is VGG-16's)
)


def int8_layer_inputs() -> dict:
    """{(input shape, per_row): int8 layer name} over one request of 4
    canvases on phase 4a's VGG-16 and the ResNet-101 COCO configuration with
    either head, under ``TEST.INT8``: each ConvInt8's NHWC input (per tensor)
    and each DenseInt8's (M, K) input (per row), from forward pre-hooks."""
    from mnc_tpu_torch import config as C
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.ops.quant import QUANT_LAYERS, ConvInt8

    archs = [("vgg16", MNCArch(pre_nms_top_n=6000, post_nms_top_n=304, nms_chunk=256,
                               compute_dtype=torch.bfloat16, int8_inference=True))]
    for roi_conv5, name in ((True, "resnet101 conv5 head"), (False, "resnet101 fc head")):
        with coco_cfg(roi_conv5):
            C.cfg_from_list(["TEST.INT8", "True"])
            archs.append((name, MNCArch.from_cfg()))
    found: dict = {}

    def hook(mod, args, name):
        conv = isinstance(mod, ConvInt8)
        x = args[0].permute(0, 2, 3, 1) if conv else args[0]
        found.setdefault((tuple(x.shape), not conv), name)

    g = torch.Generator(device="cuda").manual_seed(4)
    for arch_name, arch in archs:
        model = MNC(arch, device="cuda", seed=0)
        hooks = [m.register_forward_pre_hook(
                 lambda mod, args, name=f"{arch_name} {n}": hook(mod, args, name))
                 for n, m in model.named_modules() if isinstance(m, QUANT_LAYERS)]
        canv = torch.randint(0, 256, (4, *arch.canvas, 3), generator=g, device="cuda",
                             dtype=torch.uint8)
        infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * 4,
                             device="cuda")
        with torch.inference_mode():
            model.apply_batch(canv, infos)
        for h in hooks:
            h.remove()
        del model
        torch.cuda.empty_cache()
    if set(found) != set(INT8_LAYER_INPUTS):
        raise AssertionError(f"int8 layer inputs {sorted(found)} are not INT8_LAYER_INPUTS")
    return found


def _quant_edges(x, per_row):
    """x with quant_act's edge cases written into it (in place, per row or
    over the flattened tensor): a negative extreme -5 that sets the scale s,
    quotients one ulp either side of h + 0.5 after rounding to the dtype for
    h = 1..47, values at exactly +-127 s, and (per row) an all-zero row."""
    x.clamp_(-4.9, 4.9)
    rows = x.view(-1, x.shape[-1]) if per_row else x.view(1, -1)
    dt = x.dtype
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    s = (torch.full((), 5.0, dtype=dt, device=x.device)
         / torch.full((), 127.0, dtype=dt, device=x.device)).float()
    h = torch.arange(1, 48, device=x.device, dtype=torch.float32)
    mid = ((h + 0.5) * s).to(dt).view(bits)  # one ulp of the dtype either side of it
    vals = torch.cat([torch.tensor([-5.0], device=x.device, dtype=dt), (mid - 1).view(dt),
                      (mid + 1).view(dt), torch.stack([127 * s, -127 * s]).to(dt)])
    n = min(rows.shape[1], vals.numel())
    for r in range(min(rows.shape[0], 3)):
        rows[r, :n] = vals[:n]
    if per_row and rows.shape[0] > 3:
        rows[3] = 0
    return x


def device_activities(calls) -> dict:
    """{name: count} of the device's activities (kernels, memsets, copies)
    while ``calls`` run, one after another (torch.profiler).  The calls run
    twice: first in a warm-up step, whose events are discarded, then in the
    recorded step.  On an H100 a trace that starts on the calls themselves,
    in a process that has been profiled before, lost one kernel of the
    calls (F's halves: 15 of 16 launches of one of them); the warmed-up
    trace counts every one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # warm-up, then recorded
            for call in calls:
                call()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def check_quant_act(g):
    """Kernel F.  First its bf16 division proved by exhaustion
    (``kernels.quant_div_check_cuda``: every finite bf16 x against the scale
    of every non-negative finite bf16 absmax, 2.13e9 pairs, the division-free
    int8 against ``__fdiv_rn``'s).  Then F against quant_act (the plain
    version, on the same card tensors) at the input of every int8 layer of
    both trunks and both ResNet heads (``int8_layer_inputs``), in bf16 and
    f32, on random activations, on edge cases (``_quant_edges``) and on
    zeros: int8 values and scales bit for bit.  Timed in bf16 beside the
    plain version; the bound is the input read and the int8 output written
    once; where the plan (``kernels.plan_quant_act``) re-reads part of the
    input, the floor with that part read again from HBM is given beside it.
    The CUDA launches of one call at every shape (torch.profiler over one
    bf16 call each: every device activity must be one of F's kernels, one a
    call, no memset).  No PyTorch call computes the same function."""
    from mnc_tpu_torch import kernels
    from mnc_tpu_torch.ops.quant import quant_act

    t_check = t0 = time.perf_counter()
    proof = kernels.quant_div_check_cuda()
    torch.cuda.synchronize()
    proof["seconds"] = time.perf_counter() - t0
    log(f"kernel F bf16 division, proved by exhaustion: {proof['pairs']} pairs (every finite "
        f"bf16 x against the scale of every non-negative finite bf16 absmax), "
        f"{proof['mismatches']} int8 values differ from __fdiv_rn's (first: {proof['first']}); "
        f"{proof['seconds']:.2f} s with the build")
    if proof["mismatches"] or proof["pairs"] != 65280 * 32640:
        raise AssertionError(f"kernel F's division-free quotient is not __fdiv_rn's: {proof}")
    dev = torch.device("cuda")
    sms, smem = kernels._n_sms(dev), kernels._smem_per_block(dev)
    shapes, timed = {}, {}
    halves_ok = True
    for (shape, per_row), layer in sorted(int8_layer_inputs().items(),
                                          key=lambda kv: -int(np.prod(kv[0][0]))):
        label = f"{layer} {shape} per {'row' if per_row else 'tensor'}"
        ok = True
        for dtype in (BF, F32):
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
            for data in ("random", "edges", "zeros"):
                if data == "edges":
                    x = _quant_edges(x, per_row)
                elif data == "zeros":
                    x.zero_()
                gq, gs = kernels.quant_act_cuda(x, per_row)
                wq, ws = quant_act(x, per_row)
                ok = ok and torch.equal(gq, wq) and torch.equal(gs, ws)
                if not per_row:  # F's two halves over the two halves of H
                    hq, hs = _quant_halves(x)
                    halves_ok = halves_ok and torch.equal(hq, gq) and torch.equal(hs, gs)
            if dtype is BF:
                xr = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
                _, p_ms = _plain_ms(lambda: quant_act(xr, per_row))
                k_ms = cuda_ms(lambda: kernels.quant_act_cuda(xr, per_row), iters=10)
                q, sc = kernels.quant_act_cuda(xr, per_row)
                bms, by = bound_ms(nbytes(xr, q, sc), 0.0)
                plan = kernels.plan_quant_act(shape, per_row, dtype, sms, smem)
                twice = plan.bytes_read_twice(xr.numel(), xr.element_size())
                floor = bound_ms(nbytes(xr, q, sc) + twice, 0.0)[0]
                timed[label] = (xr, per_row)
                if not per_row:
                    halves = _time_halves(xr, q, sc)
                del q, sc
            del x, gq, gs, wq, ws
        where = "on chip" if plan.on_chip else f"re-read {twice / 1e6:.1f} MB"
        log(f"kernel F quant_act {label}: bit-identical to quant_act (bf16 and f32, random, "
            f"edge cases, zeros) {ok}; plan {where}, grid {plan.grid} x {plan.threads}, smem "
            f"{plan.smem} B; kernel_ms(bf16) {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {bms:.4f} "
            f"({by}, {bms / k_ms:.0%} of it)"
            + (f"; floor with the re-read from HBM {floor:.4f} ({floor / k_ms:.0%})"
               if twice else ""))
        shapes[label] = dict(shape=list(shape), per_row=per_row, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bms, bound_by=by, on_chip=plan.on_chip,
                             reread_mb=twice / 1e6, reread_floor_ms=floor, grid=plan.grid,
                             smem=plan.smem, bit_identical=ok)
        if not per_row:
            shapes[label]["halves"] = halves
            log(f"kernel F halves {label}: the max of the scales of the two halves of H and "
                f"each half quantized under it bit for bit F on the whole (bf16 and f32, "
                f"random, edge cases, zeros): {halves_ok}; act_scale_ms(bf16, whole) "
                f"{halves['scale_ms']:.4f} bound_ms {halves['scale_bound_ms']:.4f} "
                f"({halves['scale_bound_ms'] / halves['scale_ms']:.0%}); quant_with_scale_ms "
                f"{halves['given_ms']:.4f} plain_ms {halves['given_plain_ms']:.4f} bound_ms "
                f"{halves['given_bound_ms']:.4f} ({halves['given_bound_by']}, "
                f"{halves['given_bound_ms'] / halves['given_ms']:.0%} of it)")
        if not ok:
            raise AssertionError(f"quant_act kernel differs from its plain version ({label})")
        if not halves_ok:
            raise AssertionError(f"kernel F's halves do not compose to F ({label})")
    calls = [lambda x=x, r=r: kernels.quant_act_cuda(x, r) for x, r in timed.values()]
    acts = device_activities(calls)
    kinds = ("quant_tensor_kernel", "quant_rows_kernel")
    log(f"kernel F: CUDA launches of {len(calls)} bf16 calls, one at each shape: {acts}")
    if sum(acts.values()) != len(calls) or not all(any(k in a for k in kinds) for a in acts):
        raise AssertionError(f"kernel F: not one launch a call: {acts} for {len(calls)} calls")
    for r in shapes.values():
        r["launches_per_call"] = 1
    # the halves: one launch each, no memset
    tensors = [x for x, r in timed.values() if not r]
    one = torch.ones((), device="cuda")
    calls = [c for x in tensors for c in (lambda x=x: kernels.act_scale_cuda(x),
                                          lambda x=x: kernels.quant_with_scale_cuda(x, one))]
    acts = device_activities(calls)
    kinds = ("scale_kernel", "quant_given_kernel")
    log(f"kernel F halves: CUDA launches of {len(calls)} bf16 calls, each half at each "
        f"per-tensor shape: {acts}")
    if sum(acts.values()) != len(calls) or not all(any(k in a for k in kinds) for a in acts):
        raise AssertionError(f"kernel F halves: not one launch a call: {acts}")
    del timed, calls, tensors, one
    torch.cuda.empty_cache()
    log(f"kernel F checked in {time.perf_counter() - t_check:.1f} s")
    main = next(r for label, r in shapes.items() if r["shape"] == [4, *CANVAS, 64])
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
                division_proof=proof, halves=main["halves"], shapes=shapes)


def _quant_halves(x):
    """Kernel F's halves over the two halves of x's H (dim 1): the max of
    their scales, and each half quantized under it, concatenated."""
    from mnc_tpu_torch import kernels

    h = x.shape[1] // 2
    parts = [x[:, :h].contiguous(), x[:, h:].contiguous()]
    scale = torch.stack([kernels.act_scale_cuda(p) for p in parts]).max()
    return torch.cat([kernels.quant_with_scale_cuda(p, scale) for p in parts], dim=1), scale


def _time_halves(x, q, scale) -> dict:
    """F's halves on the whole of x (bf16): the scale alone (bound: x read
    once) and the quantization under ``scale`` (bound: x read once, the
    int8 written once), beside the plain ``quant_with_scale``."""
    from mnc_tpu_torch import kernels
    from mnc_tpu_torch.ops.quant import quant_with_scale

    s_ms = cuda_ms(lambda: kernels.act_scale_cuda(x), iters=10)
    q_ms = cuda_ms(lambda: kernels.quant_with_scale_cuda(x, scale), iters=10)
    _, p_ms = _plain_ms(lambda: quant_with_scale(x, scale))
    sb, sby = bound_ms(nbytes(x, scale), 0.0)
    qb, qby = bound_ms(nbytes(x, q), 0.0)
    return dict(scale_ms=s_ms, scale_bound_ms=sb, scale_bound_by=sby, given_ms=q_ms,
                given_plain_ms=p_ms, given_bound_ms=qb, given_bound_by=qby)


def _check_serving(out, arch, b, k):
    """Shapes (``k`` detections per canvas), finite values, some valid
    detection, classes in [1, C), bool canvases of a ``detect_canvas_batch``
    result; the count of valid ones."""
    shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k),
              "masks": (b, k, arch.mask_size, arch.mask_size), "valid": (b, k),
              "canvas_masks": (b, k, *arch.canvas)}
    for key, shp in shapes.items():
        if tuple(out[key].shape) != shp:
            raise AssertionError(f"{key} has shape {tuple(out[key].shape)}, want {shp}")
    for key in ("boxes", "scores", "masks"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key} is not finite")
    if not out["valid"].any() or out["canvas_masks"].dtype != torch.bool:
        raise AssertionError("no valid detection / canvas masks not bool")
    cls = out["classes"]
    if not ((cls >= 1) & (cls < arch.num_classes)).all():
        raise AssertionError("classes out of range")
    return int(out["valid"].sum())


def serve_path(device_label, name, arch, n_requests=2):
    """``MNCPipeline.detect_canvas_batch`` at full width on ``arch``: one
    warm-up request, then ``n_requests`` requests of 4 canvases, each checked
    (shapes, finite values, some valid detection, classes in [1, C), bool
    canvases).  Returns the launch counts of those requests."""
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    t0 = time.perf_counter()
    model = MNC(arch, device="cuda", seed=0)
    pipe = MNCPipeline(model, PostCfg.from_cfg(dets_per_class=16))
    log(f"serve {name}: model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{arch.compute_dtype}; trunk {arch.trunk}, roi_conv5 {arch.roi_conv5}, "
        f"{arch.num_classes} classes, pre-NMS {arch.pre_nms_top_n}, post-NMS "
        f"{arch.post_nms_top_n})")
    g = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    reqs = [torch.randint(0, 256, (b, *arch.canvas, 3), generator=g, device="cuda",
                          dtype=torch.uint8) for _ in range(n_requests + 1)]
    infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * b,
                         device="cuda")
    pipe.detect_canvas_batch(reqs[-1], infos)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # each request's result is checked after its timing and then dropped, as
    # a server hands it on, so later requests reuse the same device memory
    lat, n_valid = [], []
    for r in range(n_requests):
        t0 = time.perf_counter()
        out = pipe.detect_canvas_batch(reqs[r], infos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        n_valid.append(_check_serving(out, arch, b, pipe.post.max_per_image))
        del out
    counts = launch_counts()
    log(f"serve {name}: launches {counts}; valid detections per request {n_valid}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve {name} on {device_label}: latency per request of {b} canvases "
        + ", ".join(f"{x * 1e3:.1f} ms" for x in lat)
        + f"; {len(lat) * b / sum(lat):.2f} img/s")
    return counts


def _synthetic_batch(arch, indices, max_gt=32):
    from mnc_tpu_torch.data.synthetic import SyntheticShapes

    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=6, max_gt=max_gt,
                           gt_mask_size=28, n_range=(2, 5), seed=11)
    return {k: torch.from_numpy(v).cuda() for k, v in data.batch(indices).items()}


def train_path(device_label, name, arch):
    """3 full-width optimizer steps of 2 images on ``arch`` with the solver
    of ``cfg.TRAIN`` (its ``CLIP_GRADIENTS`` included).  Every loss must be
    finite; every parameter must move except the frozen ones that the solver
    cannot move (no gradient reaches the frozen blocks or stages, which
    autograd shows; of those, biases take no decay and a zero kernel or scale
    decays to zero); the stage-2/3 losses alone must reach
    ``rpn_bbox_pred``.  Returns the launch counts of the 3 steps and what the
    fused-block-1 phase goes on with."""
    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.train.loop import (TrainState, draw_step_randoms, make_train_step,
                                          mnc_loss, train_cfg_from_cfg)
    from mnc_tpu_torch.train.optim import make_optimizer

    train_cfg = train_cfg_from_cfg(cfg)
    t0 = time.perf_counter()
    model = MNC(arch, device="cuda", seed=0, train=True)
    opt = make_optimizer(model, base_lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
                         weight_decay=cfg.TRAIN.WEIGHT_DECAY, gamma=cfg.TRAIN.GAMMA,
                         stepsize=cfg.TRAIN.STEPSIZE, clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
    step = make_train_step(model, opt, arch, train_cfg)
    state = TrainState.create(model, opt)
    log(f"train {name}: model built in {time.perf_counter() - t0:.1f} s (f32 master "
        f"parameters, {arch.compute_dtype} compute; trunk {arch.trunk}, roi_conv5 "
        f"{arch.roi_conv5}, {arch.num_classes} classes, trunk_frozen {arch.trunk_frozen}, "
        f"clip_gradients {cfg.TRAIN.CLIP_GRADIENTS})")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ims = 2
    batches = [_synthetic_batch(arch, [2 * i, 2 * i + 1]) for i in range(5)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(state, batches[4], gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        _, metrics = step(state, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        if not all(x == x and abs(x) != float("inf") for x in m.values()):
            raise AssertionError(f"train {name}: a loss is not finite: {m}")
        log(f"train {name} step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {name}: launches {counts}; peak memory {peak:.2f} GiB")
    log(f"train {name} on {device_label}: step time for {ims} images "
        + ", ".join(f"{x * 1e3:.1f} ms" for x in times)
        + f"; {len(times) * ims / sum(times):.2f} img/s")

    # one more forward: the cascade property (the stage-2/3 losses alone
    # reach rpn_bbox_pred, through kernel A' to the box coordinates), then
    # the whole loss's backward, which leaves the frozen parameters without
    # a gradient
    draws = draw_step_randoms(gen, arch, train_cfg, ims, 32)
    total, losses = mnc_loss(model, batches[3], draws, arch, model.anchors, train_cfg)
    (g_rpn,) = torch.autograd.grad(losses["s23_mask"] + losses["s23_cls"] + losses["s23_bbox"],
                                   model.rpn_head.rpn_bbox_pred.weight, retain_graph=True)
    gmax = g_rpn.abs().max().item()
    log(f"train {name}: max |d(stage-2/3 losses)/d rpn_bbox_pred.weight| = {gmax:.3e}")
    if not gmax > 0.0:
        raise AssertionError(f"train {name}: stage-2/3 losses do not reach rpn_bbox_pred")
    total.backward()
    frozen = sorted(n for n, p in model.named_parameters() if p.grad is None)
    model.zero_grad(set_to_none=True)
    if not frozen or not all(n.startswith("trunk.") for n in frozen):
        raise AssertionError(f"train {name}: parameters without a gradient: {frozen}")
    is_bias = dict(zip(opt.names, opt.is_bias))
    keep = sorted(n for n in frozen if is_bias[n] or not before[n].any())
    still = sorted(n for n, p in model.named_parameters() if torch.equal(p, before[n]))
    log(f"train {name}: {len(frozen)} frozen parameters (no gradient); the {len(keep)} of "
        f"them that the solver cannot move: {', '.join(keep)}")
    if still != keep:
        raise AssertionError(f"train {name}: parameters unchanged: {still}, expected only "
                             f"{keep}")
    del before
    return counts, (model, opt, state, batches, gen, train_cfg)


def fused_block1_path(model, opt, state, batches, gen, train_cfg):
    """One train step and one serving request of the VGG-16 model with
    ``fused_block1=True`` (kernel D on the trunk), whose features are held
    against the unfused trunk's.  Returns their launch counts."""
    import dataclasses

    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.train.loop import make_train_step

    feats = model.features(batches[3]["image"]).float()
    fused_arch = dataclasses.replace(model.arch, fused_block1=True)
    model.arch = fused_arch
    model.trunk.fused_block1 = True
    reset_launch_counts()
    fused_feats = model.features(batches[3]["image"]).float()
    diff = (fused_feats - feats).abs().max().item()
    tol = 0.15 * feats.abs().max().item()
    log(f"fused block 1: trunk features vs the unfused trunk's: max abs diff {diff:.3e} "
        f"(tolerance {tol:.3e} = 0.15 of max |feature|: 1-ulp block-1 deviations pass "
        f"through 11 more bf16 layers)")
    if not diff <= tol:
        raise AssertionError("fused block 1: trunk features disagree with the unfused trunk")
    _, metrics = make_train_step(model, opt, fused_arch, train_cfg)(state, batches[3], gen)
    torch.cuda.synchronize()
    m = {k: float(v) for k, v in metrics.items()}
    if not all(x == x and abs(x) != float("inf") for x in m.values()):
        raise AssertionError(f"fused block 1: a loss is not finite: {m}")
    out = model.apply_batch(batches[3]["image"], batches[3]["im_info"])
    torch.cuda.synchronize()
    if not all(torch.isfinite(out[k]).all() for k in ("rois", "cls_prob", "mask_logits")):
        raise AssertionError("fused block 1: serving outputs are not finite")
    fused_counts = launch_counts()
    log(f"fused block 1: train step total {m['total']:.4f}; launches {fused_counts}")
    return fused_counts


@contextlib.contextmanager
def coco_cfg(roi_conv5: bool):
    """The ResNet-101 COCO configuration (``experiments/cfgs/
    mnc_coco_resnet101.yml`` with ``NET.ROI_CONV5`` as given) in the global
    cfg, which is restored afterwards."""
    from mnc_tpu_torch import config as C

    saved = C.cfg.clone()
    try:
        C.cfg_from_file(os.path.join(REPO, "experiments", "cfgs", "mnc_coco_resnet101.yml"))
        C.cfg_from_list(["NET.ROI_CONV5", str(roi_conv5)])
        yield C.cfg
    finally:
        C.cfg.clear()
        C.cfg.update(saved)


def randomize_frozen_bn(model, seed):
    """Draws every FrozenBN leaf anew from a seeded CPU generator, the same
    on any device (as ``tests/test_torch_resnet.py::randomize_bn``): scales
    in [0.5, 1.5], each ``bn3``'s in [0.1, 0.3], the stem's divided by 64,
    biases in [-0.3, 0.3].  At init every ``bn3`` scale is 0, so each block
    would be its shortcut and its convolutions would not be compared."""
    from mnc_tpu_torch.models.resnet import FrozenBN

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, FrozenBN):
                lo, hi = (0.1, 0.3) if m.zero_scale else (0.5, 1.5)
                scale = lo + (hi - lo) * torch.rand(m.scale.shape, generator=gen)
                m.scale.copy_(scale / (64.0 if name == "trunk.bn1" else 1.0))
                m.bias.copy_(0.6 * torch.rand(m.bias.shape, generator=gen) - 0.3)
    return model


# the small ResNet-50 with the conv5 head that is held card against CPU
RESNET_SMALL = dict(trunk="resnet50", roi_conv5=True)


def small_train_step_agrees(arch_kw=None):
    """One train step of a small f32 model on the card against the same
    model on the CPU (plain versions), on the same draws: selections
    identical, losses and gradients within the stated tolerances."""
    from mnc_tpu_torch.data.synthetic import SyntheticShapes
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.train import targets as T
    from mnc_tpu_torch.train.loop import draw_step_randoms, mnc_loss

    arch_kw = arch_kw or {}
    arch = MNCArch(canvas=(128, 160), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, compute_dtype=torch.float32, fc_dim=64, mask_fc_dim=32,
                   pre_nms_top_n=128, post_nms_top_n=32, rpn_min_size=4.0, trunk_frozen=0,
                   **arch_kw)
    train_cfg = dict(RPN_POSITIVE_OVERLAP=0.7, RPN_NEGATIVE_OVERLAP=0.3, RPN_BATCHSIZE=64,
                     RPN_FG_FRACTION=0.5, BATCH_SIZE=32, FG_FRACTION=0.25, FG_THRESH=0.5,
                     BG_THRESH_HI=0.5, BG_THRESH_LO=0.0)
    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=4, max_gt=4, gt_mask_size=16,
                           n_range=(1, 2), seed=7)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([0, 1]).items()}
    draws = draw_step_randoms(torch.Generator().manual_seed(9), arch, train_cfg, 2, 4)
    picked = {}
    orig = T.proposal_targets

    def spy(*a, **kw):  # record the sampled RoIs and labels of both runs
        out = orig(*a, **kw)
        picked.setdefault(out.rois.device.type, []).append((out.rois.detach().cpu(),
                                                            out.labels.cpu()))
        return out

    T.proposal_targets = spy
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            model = MNC(arch, device=dev, seed=3, train=True)
            if arch.trunk != "vgg16":
                randomize_frozen_bn(model, 4)
            to = lambda t: t.to(dev)  # noqa: E731
            d = type(draws)(*(tuple(to(x) for x in f) for f in draws))
            total, losses = mnc_loss(model, {k: to(v) for k, v in batch.items()}, d, arch,
                                     model.anchors, train_cfg)
            total.backward()
            res[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()})
    finally:
        T.proposal_targets = orig
    for (gr, gl), (cr, cl) in zip(picked["cuda"], picked["cpu"]):
        if not (torch.equal(gl, cl) and (gr - cr).abs().max().item() <= 1e-3):
            raise AssertionError("small train step: sampled RoIs or labels differ")
    loss_err = max(abs(res["cuda"][0][k] - v) / max(abs(v), 1e-6)
                   for k, v in res["cpu"][0].items())
    errs = {"trunk": 0.0, "heads": 0.0}
    for n, g in res["cpu"][1].items():
        err = ((res["cuda"][1][n] - g).abs().max() / g.abs().max().clamp_min(1e-12)).item()
        part = "trunk" if n.startswith("trunk.") else "heads"
        errs[part] = max(errs[part], err)
    # In f32 a ReLU unit whose pre-activation is within rounding of 0 can lie
    # on different sides on the card and on the CPU; of the trunk's ~1.6
    # million units one or two do, and each moves its channel's gradient by
    # several percent of the leaf's max.  The RPN and head leaves (a few
    # thousand units) are held tightly: rpn_bbox_pred's gradient arrives
    # through kernel A' (the box coordinates).
    log(f"small f32 train step ({arch.trunk}, roi_conv5 {arch.roi_conv5}), card vs CPU: "
        f"sampled RoIs and labels identical; max relative loss diff {loss_err:.2e} "
        f"(tolerance 1e-4); max gradient diff relative to each leaf's max: RPN and heads "
        f"{errs['heads']:.2e} (tolerance 1e-3), trunk {errs['trunk']:.2e} (tolerance 0.15)")
    if loss_err > 1e-4 or errs["heads"] > 1e-3 or errs["trunk"] > 0.15:
        raise AssertionError("small train step: card and CPU disagree beyond tolerance")


def small_model_agrees(arch_kw=None):
    """A small f32 model on the card vs the same weights on the CPU, where
    every kernel runs its plain version."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, compute_dtype=torch.float32, fc_dim=64, mask_fc_dim=32,
                   pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0, **(arch_kw or {}))
    post = PostCfg(dets_per_class=4, max_per_image=8)
    g = torch.Generator().manual_seed(2)
    imgs = torch.randint(0, 256, (2, 96, 128, 3), generator=g, dtype=torch.uint8)
    infos = torch.tensor([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]])
    out = {}
    for dev in ("cuda", "cpu"):
        model = MNC(arch, device=dev, seed=3)
        if arch.trunk != "vgg16":
            randomize_frozen_bn(model, 4)
        out[dev] = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    gpu, cpu = out["cuda"], out["cpu"]
    for key in ("valid", "classes"):
        if not torch.equal(gpu[key].cpu(), cpu[key]):
            raise AssertionError(f"small model: {key} differs between card and CPU")
    errs = {key: (gpu[key].cpu() - cpu[key]).abs().max().item()
            for key in ("boxes", "scores", "masks")}
    flips = (gpu["canvas_masks"].cpu() != cpu["canvas_masks"]).float().mean().item()
    log(f"small f32 model ({arch.trunk}, roi_conv5 {arch.roi_conv5}), card vs CPU: "
        f"selections identical ({int(cpu['valid'].sum())} valid); max abs diff {errs}; "
        f"canvas pixels differing {flips:.2e}")
    if errs["boxes"] > 1e-2 or errs["scores"] > 1e-4 or errs["masks"] > 1e-3 or flips > 1e-3:
        raise AssertionError("small model: card and CPU disagree beyond tolerance")


# the detect_many stream: common photo sizes, both orientations (h, w)
STREAM_SIZES = [(375, 500), (500, 375), (333, 500), (480, 640), (427, 640), (640, 480)]


def import_caffemodel(tmp):
    """Write a full-size seeded VGG-16 caffemodel with the port's fabricator
    (binary, mask size 28) and import it as a user would: the default cfg's
    arch, auto-configured by the file (M = 21 → 28, bbox de-normalization
    and anchor suppression off), on the card."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.tools import fabricate_caffemodel
    from mnc_tpu_torch.utils.caffemodel import read_caffemodel
    from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                load_import_weights, state_dict_from_jax)

    path = os.path.join(tmp, "mnc_vgg16.caffemodel")
    t0 = time.perf_counter()
    fabricate_caffemodel.main([path, "--seed", "0"])
    t1 = time.perf_counter()

    def make_params(a):
        return jax_params_from_state_dict(MNC(a, device="cpu", train=True).state_dict())

    arch = MNCArch.from_cfg()
    params, arch = load_import_weights(path, None, arch, make_params(arch),
                                       make_params=make_params)
    if (arch.mask_size, arch.bbox_pred_normalized, arch.suppress_untrainable_anchors) != (
            28, False, False):
        raise AssertionError(f"caffemodel import: unexpected arch {arch}")
    model = MNC(arch, device="cuda")
    model.load_state_dict(state_dict_from_jax(params))
    fc6 = read_caffemodel(path)["fc6"][0]  # (4096, 512·7·7), inputs CHW
    got = model.classify_head.fc6.weight.float().cpu().numpy()  # (4096, 7·7·512), HWC
    want = fc6.reshape(4096, 512, 7, 7).transpose(0, 2, 3, 1).reshape(4096, -1)
    err = float(abs(got - want).max())
    log(f"caffemodel import: {os.path.getsize(path) / 2**20:.1f} MiB written in {t1 - t0:.1f} s, "
        f"imported in {time.perf_counter() - t1:.1f} s; mask_size {arch.mask_size}, "
        f"bbox_pred_normalized {arch.bbox_pred_normalized}, suppress_untrainable_anchors "
        f"{arch.suppress_untrainable_anchors}; fc6 on the card vs the file (CHW → HWC): "
        f"max abs diff {err:.2e} (tolerance 2e-4: half a bf16 ulp of |w| < 0.06)")
    if not err <= 2e-4:
        raise AssertionError("caffemodel import: fc6 weights did not land in HWC order")
    return model


def _check_dets(name, res, images, num_classes):
    for im, d in zip(images, res):
        k = len(d["scores"])
        if d["full_masks"].shape != (k, *im.shape[:2]) or d["full_masks"].dtype != "uint8":
            raise AssertionError(f"{name}: full_masks {d['full_masks'].shape} for {im.shape}")
        if not all(np.isfinite(d[key]).all() for key in ("boxes", "scores", "masks")):
            raise AssertionError(f"{name}: a value is not finite")
        cls = d["classes"][d["valid"]]
        if not d["valid"].any() or not ((cls >= 1) & (cls < num_classes)).all():
            raise AssertionError(f"{name}: no valid detection or a class out of range")


def stream_path(device_label, model):
    """``MNCPipeline.detect_many`` over 16 seeded uint8 BGR images of mixed
    sizes and orientations, batch 4, the default TEST config (uint8 upload,
    packed transfer, auto-portrait: the portrait images run on the 1024x640
    view of the same parameters).  Checked: shapes, finite values, the
    portrait variant ran; host_paste gives the same boxes, scores and
    classes; one ``detect`` gives that image's selections and scores.  Returns the
    launch counts of one stream and the stream's numbers."""
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.pipeline.inference import MNCPipeline

    rs = np.random.RandomState(0)
    images = [rs.randint(0, 256, (*STREAM_SIZES[i % 6], 3)).astype(np.uint8)
              for i in range(16)]
    pipe = MNCPipeline(model)
    t0 = time.perf_counter()
    warmed = pipe.prewarm(batch_size=4)
    log(f"detect_many: prewarm of {warmed} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.detect_many(images, batch_size=4)
    walls = [time.perf_counter() - t0]
    counts = launch_counts()
    if tuple(model.arch.canvas[::-1]) not in pipe._variants:
        raise AssertionError("detect_many: the portrait canvas did not run")
    _check_dets("detect_many", res, images, model.arch.num_classes)
    for _ in range(2):
        t0 = time.perf_counter()
        pipe.detect_many(images, batch_size=4)
        walls.append(time.perf_counter() - t0)
    timings: dict = {}
    t0 = time.perf_counter()
    pipe.detect_many(images, batch_size=4, timings=timings)
    split_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_portrait = sum(h > w for h, w in (im.shape[:2] for im in images))
    log(f"detect_many: launches {counts}; {n_portrait} of 16 images portrait; valid "
        f"detections per image {[int(d['valid'].sum()) for d in res]}; peak memory "
        f"{peak:.2f} GiB")
    log(f"detect_many on {device_label}: 16 images ({', '.join(f'{h}x{w}' for h, w in STREAM_SIZES)}"
        f"), batch 4: wall " + ", ".join(f"{x * 1e3:.1f} ms" for x in walls)
        + f"; {16 / min(walls):.2f} images/s at the best, {16 * len(walls) / sum(walls):.2f} "
        f"over the {len(walls)} streams")
    log(f"detect_many split on {device_label} (a synchronize closing each phase; "
        f"wall {split_wall * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timings.items()))
    unpacked: dict = {}  # the same stream with the masks sent as bytes, not bits
    t0 = time.perf_counter()
    res_u = pipe.detect_many(images, batch_size=4, packed=False, timings=unpacked)
    log(f"detect_many split, packed=False, on {device_label} (wall "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in unpacked.items()))
    if not all(np.array_equal(a["full_masks"], b["full_masks"]) for a, b in zip(res_u, res)):
        raise AssertionError("detect_many: packed and unpacked full masks differ")

    busy_ms, _, top, traced_ms = traced(lambda: pipe.detect_many(images, batch_size=4), 10)
    log(f"detect_many traced on {device_label}: device busy {busy_ms:.1f} ms of the best "
        f"stream's wall {min(walls) * 1e3:.1f} ms (idle share {1 - busy_ms / (min(walls) * 1e3):.3f};"
        f" the traced stream's own wall {traced_ms:.1f} ms); top kernels: " + top)

    hp = pipe.detect_many(images, batch_size=4, host_paste=True)
    _check_dets("detect_many host_paste", hp, images, model.arch.num_classes)
    for key in ("boxes", "scores", "classes", "valid"):
        if not all(np.array_equal(a[key], b[key]) for a, b in zip(hp, res)):
            raise AssertionError(f"detect_many: host_paste {key} differ from the pasting run")
    log("detect_many host_paste: boxes, scores, classes and valid bit-equal to the "
        "pasting run")
    # The fabricated weights (seeded, scale 0.01) leave every class
    # probability near 1/21, so detections tie to ~1e-5 and their order
    # within those ties follows the last bits, which a batch of 1 and a batch
    # of 4 (other GEMM shapes in bf16) round differently.  At full width a
    # single detect is held to the stream's selections and scores rank by
    # rank; small_detect_many_agrees holds the whole result on the card.
    for j in (0, 1):  # a landscape and a portrait image
        one = pipe.detect(images[j])
        score_diff = float(np.abs(one["scores"] - res[j]["scores"]).max())
        same = (np.array_equal(one["valid"], res[j]["valid"])
                and np.array_equal(np.sort(one["classes"]), np.sort(res[j]["classes"])))
        box_diff = float(np.abs(one["boxes"] - res[j]["boxes"]).max())
        log(f"detect of image {j} ({images[j].shape[0]}x{images[j].shape[1]}) vs its "
            f"detect_many result: valid and the classes' multiset "
            f"{'identical' if same else 'DIFFER'}; scores rank by rank within "
            f"{score_diff:.2e} (tolerance 1e-4); boxes rank by rank up to {box_diff:.1f} px "
            f"apart (near-tied detections change places)")
        if not same or score_diff > 1e-4:
            raise AssertionError("detect differs from detect_many beyond tolerance")
    stats = dict(images=16, batch=4, wall_ms=[x * 1e3 for x in walls],
                 images_per_s=16 / min(walls), split_ms={k: v * 1e3 for k, v in timings.items()},
                 split_unpacked_ms={k: v * 1e3 for k, v in unpacked.items()},
                 device_busy_ms=busy_ms,
                 peak_gib=peak)
    return counts, stats


def custom_op_overhead(g):
    """Each kernel through its custom op (``mnc::*``) against its direct
    wrapper on the same inputs: outputs identical, then the host time of a
    call each way (host clock over 200 back-to-back calls at a small shape,
    ending in a synchronize; op, direct, direct, op).  Returns {name: us per
    call through the op, directly, and the difference}."""
    from mnc_tpu_torch import kernels
    from mnc_tpu_torch.ops.block1 import block1_op, packed_block1_weights
    from mnc_tpu_torch.ops.masks import paste_binarize_op
    from mnc_tpu_torch.ops.nms import nms_keep_op
    from mnc_tpu_torch.ops.roi_warp import roi_warp_op

    feat = torch.randn(1, 8, 8, 8, generator=g, device="cuda")
    rois = random_boxes(g, 4, 128, 128, hi=64.0)[None].contiguous()
    boxes = random_boxes(g, 64, 128, 128, hi=64.0)[None].contiguous()
    valid = torch.ones(1, 64, dtype=torch.bool, device="cuda")
    wy = torch.rand(2, 16, 5, generator=g, device="cuda")
    masks = torch.rand(2, 5, 5, generator=g, device="cuda")
    wxt = torch.rand(2, 5, 16, generator=g, device="cuda")
    x = (torch.randn(1, 8, 16, 3, generator=g, device="cuda") * 50).to(torch.bfloat16)
    ws = (torch.randn(64, 3, 3, 3, generator=g, device="cuda") * 0.1,
          torch.randn(64, generator=g, device="cuda"),
          torch.randn(64, 64, 3, 3, generator=g, device="cuda") * 0.05,
          torch.randn(64, generator=g, device="cuda"))
    pairs = {
        "roi_warp": (lambda: roi_warp_op(feat, rois, 2, 2, 0.25),
                     lambda: kernels.roi_warp_cuda(feat, rois, (2, 2), 0.25)),
        "nms": (lambda: nms_keep_op(boxes, valid, 0.5, 0),
                lambda: kernels.nms_keep_cuda(boxes, valid, 0.5, 0)),
        "paste_binarize": (lambda: paste_binarize_op(wy, masks, wxt, 0.4),
                           lambda: kernels.paste_binarize_cuda(wy, masks, wxt, 0.4)),
        "block1": (lambda: block1_op(x, *ws),
                   lambda: kernels.block1_cuda(x, *packed_block1_weights(*ws))),
    }

    def host_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    for name, (op, direct) in pairs.items():
        if not torch.equal(op(), direct()):
            raise AssertionError(f"custom op mnc::{name} differs from its direct wrapper")
        for _ in range(20):  # warm-up
            op(), direct()
        t = [host_us(f) for f in (op, direct, direct, op)]
        op_us, direct_us = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[name] = dict(op_us=op_us, direct_us=direct_us, overhead_us=op_us - direct_us)
    log("custom ops on the card: outputs identical to the direct wrappers; host us per call "
        "(op / direct / overhead, mean of two runs of 200 each way): "
        + "; ".join(f"{k} {v['op_us']:.1f} / {v['direct_us']:.1f} / {v['overhead_us']:.1f}"
                    for k, v in out.items()))
    return out


def _post(port, body, timeout=120):
    """POST ``body`` to /detect → (status, parsed JSON, seconds)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/detect", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, json.loads(data), time.perf_counter() - t0


def _npy(im) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, im)
    return buf.getvalue()


def _serve_in_thread(srv):
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    if srv.batcher is not None:
        srv.batcher.close()
    thread.join(timeout=10)
    if thread.is_alive():
        raise AssertionError("the HTTP server thread did not stop")


N_TIMED = 60  # exported/eager request pairs timed in phase 4g


def _subprocess_artifact(path, inputs, outputs):
    """Load the artifact at ``path`` in a fresh interpreter that must import
    no model code, run it on the canvases saved at ``inputs`` (one warm-up
    call, then one counted call), save the counted call's outputs to
    ``outputs``; returns the JSON line it prints (load seconds, launch
    counts of the counted call)."""
    code = (
        "import json, sys, time, torch\n"
        "t0 = time.perf_counter()\n"
        "from mnc_tpu_torch.pipeline.export import load_exported\n"
        "from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts\n"
        "fn = load_exported(sys.argv[1])\n"
        "load_s = time.perf_counter() - t0\n"
        "models = sorted(m for m in sys.modules if m.startswith('mnc_tpu_torch.models'))\n"
        "if models:\n"
        "    raise SystemExit(f'the artifact loader imported model code: {models}')\n"
        "inp = torch.load(sys.argv[2])\n"
        "c, i = inp['canvases'].cuda(), inp['im_infos'].cuda()\n"
        "fn(c, i)\n"
        "torch.cuda.synchronize()\n"
        "reset_launch_counts()\n"
        "out = fn(c, i)\n"
        "torch.cuda.synchronize()\n"
        "counts = launch_counts()\n"
        "torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[3])\n"
        "print(json.dumps({'load_s': load_s, 'launches': counts}))\n"
    )
    res = subprocess.run([sys.executable, "-c", code, path, inputs, outputs], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"the artifact's subprocess failed:\n{res.stdout}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def serving_entry_points(device_label, model, tmp):
    """Phase 4g, on the imported full-size model of phase 4f (M = 28, the
    default TEST config):

    (i)   the server of ``serve --http 0 --http-batch 4`` (``make_http_server``
          with a ``MicroBatcher`` over ``detect_many``) in a thread; 8 client
          threads POST phase 4f's 16 images as ``.npy`` bodies: every reply
          200, every RLE of the original size, the batches formed summing to
          16; requests/s and latency printed;
    (ii)  the single-mode server (``serve --http 0``): its replies for 2 images
          equal ``dets_to_json(pipe.detect(im))`` exactly;
    (iii) the batched (B = 4) artifact of ``export_inference``, loaded in a
          fresh subprocess that imports no model code, on phase 4a's
          canvases: valid, classes and canvas masks identical to
          ``detect_canvas_batch``, boxes within 1e-3 px, scores within 1e-6,
          soft masks within 1e-5 (the same aten ops and kernels run, so
          bit-equal is expected); exported and eager request times over
          ``N_TIMED`` pairs interleaved in this process;
    (iv)  ``ExportedPipeline.detect`` of the single-image artifact on one
          image equals ``MNCPipeline.detect`` (every key, exactly).

    Scores of the fabricated weights (~1/21) lie below ``serve``'s default
    ``--conf`` 0.7, so the replies keep every valid instance (conf 0).
    Returns the launch counts by path."""
    import threading

    from mnc_tpu_torch import native
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.pipeline.export import (ExportedPipeline, export_inference,
                                               load_exported, save_exported)
    from mnc_tpu_torch.pipeline.inference import MNCPipeline
    from mnc_tpu_torch.tools.serve import build_server, dets_to_json, parse_args

    conf = 0.0
    rs = np.random.RandomState(0)  # phase 4f's stream
    images = [rs.randint(0, 256, (*STREAM_SIZES[i % 6], 3)).astype(np.uint8)
              for i in range(16)]
    bodies = [_npy(im) for im in images]
    pipe = MNCPipeline(model)
    pipe.prewarm(batch_size=4)
    by_path = {}

    # (i) micro-batched, as `serve --http 0 --http-batch 4 --conf 0` builds it
    srv = build_server(parse_args(["--http", "0", "--http-batch", "4", "--conf", str(conf)]),
                       pipe, host="127.0.0.1")
    port = srv.server_address[1]
    thread = _serve_in_thread(srv)
    try:
        status, _, _ = _post(port, bodies[0])  # warm-up of the server path
        if status != 200:
            raise AssertionError(f"micro-batched server: warm-up reply {status}")
        srv.batcher.batch_sizes.clear()
        replies = [None] * 16
        torch.cuda.synchronize()
        reset_launch_counts()

        def client(c):
            for j in range(c, 16, 8):
                replies[j] = _post(port, bodies[j])

        clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        by_path["serve_http"] = launch_counts()
        sizes = list(srv.batcher.batch_sizes)
    finally:
        _stop(srv, thread)
    if any(t.is_alive() for t in clients) or any(r is None for r in replies):
        raise AssertionError("micro-batched server: a client did not finish")
    n_inst = []
    for im, (status, obj, _) in zip(images, replies):
        if status != 200:
            raise AssertionError(f"micro-batched server: reply {status}: {obj}")
        for inst in obj["instances"]:
            m = native.rle_decode(inst["mask_rle"])
            if tuple(inst["mask_rle"]["size"]) != im.shape[:2] or m.shape != im.shape[:2]:
                raise AssertionError("micro-batched server: an RLE is not of its image's size")
        n_inst.append(len(obj["instances"]))
    if sum(sizes) != 16 or not all(n > 0 for n in n_inst):
        raise AssertionError(f"micro-batched server: batches {sizes}, instances {n_inst}")
    lat = sorted(r[2] * 1e3 for r in replies)
    log(f"serve_http micro-batched on {device_label}: 16 .npy requests from 8 clients in "
        f"{wall * 1e3:.1f} ms: {16 / wall:.2f} requests/s (RLE by the compiled host helper; "
        f"with numpy's RLE this server answered 7.0-8.2 requests/s on one H100); latency median "
        f"{np.median(lat):.1f} ms, worst {lat[-1]:.1f} ms; batches formed {sizes}; instances "
        f"per reply {n_inst}; launches {by_path['serve_http']}")
    # the same work without HTTP, split: detect_many, then the replies' RLE and JSON
    t0 = time.perf_counter()
    dets = pipe.detect_many(images, batch_size=4)
    t1 = time.perf_counter()
    bodies_out = [json.dumps(dets_to_json(d, conf)) for d in dets]
    t2 = time.perf_counter()
    log(f"serve_http split, the same 16 images in-process: detect_many {(t1 - t0) * 1e3:.1f} ms, "
        f"dets_to_json (RLE of {sum(n_inst)} masks) + json.dumps {(t2 - t1) * 1e3:.1f} ms "
        f"({sum(map(len, bodies_out)) / 2**20:.2f} MiB of replies); the rest of the wall is "
        f"HTTP, .npy decoding and waiting for batches")

    # (ii) single mode, as `serve --http 0 --conf 0` builds it
    srv = build_server(parse_args(["--http", "0", "--conf", str(conf)]), pipe, host="127.0.0.1")
    thread = _serve_in_thread(srv)
    try:
        reset_launch_counts()
        got = [_post(srv.server_address[1], bodies[j]) for j in (0, 1)]
        by_path["serve_http_single"] = launch_counts()
    finally:
        _stop(srv, thread)
    for j, (status, obj, _) in zip((0, 1), got):
        want = json.loads(json.dumps(dets_to_json(pipe.detect(images[j]), conf)))
        if status != 200 or obj != want:
            raise AssertionError(f"single-mode server: the reply for image {j} differs from "
                                 "dets_to_json(pipe.detect(im))")
    log(f"serve_http single mode: replies for images 0 and 1 ({len(got[0][1]['instances'])} "
        f"and {len(got[1][1]['instances'])} instances) equal dets_to_json(pipe.detect(im)); "
        f"{', '.join(f'{r[2] * 1e3:.1f} ms' for r in got)}")

    # (iii) the batched artifact in a fresh subprocess, on phase 4a's canvases
    arch = model.arch
    g = torch.Generator(device="cuda").manual_seed(1)
    canvases = torch.randint(0, 256, (4, *arch.canvas, 3), generator=g, device="cuda",
                             dtype=torch.uint8)
    infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * 4,
                         device="cuda")
    t0 = time.perf_counter()
    blob = export_inference(model, pipe.post, batch=4)
    t_export = time.perf_counter() - t0
    path = os.path.join(tmp, "mnc_vgg16_b4.pt2")
    t0 = time.perf_counter()
    save_exported(path, blob)
    t_save = time.perf_counter() - t0
    size_mb = len(blob) / 2**20
    del blob
    inputs, outputs = os.path.join(tmp, "canvases.pt"), os.path.join(tmp, "exported_out.pt")
    torch.save({"canvases": canvases.cpu(), "im_infos": infos.cpu()}, inputs)
    sub = _subprocess_artifact(path, inputs, outputs)
    by_path["exported"] = sub["launches"]
    got = torch.load(outputs)
    want = {k: v.cpu() for k, v in pipe.detect_canvas_batch(canvases, infos).items()}
    if set(got) != set(want):
        raise AssertionError(f"exported: keys {sorted(got)} vs {sorted(want)}")
    for key in ("valid", "classes", "canvas_masks"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"exported: {key} differs from detect_canvas_batch")
    diffs = {k: (got[k].float() - want[k].float()).abs().max().item()
             for k in ("boxes", "scores", "masks")}
    log(f"exported B=4 artifact on {device_label}: {size_mb:.1f} MiB; export "
        f"{t_export:.1f} s, save {t_save:.1f} s, load in a fresh process {sub['load_s']:.1f} s "
        f"(no model code imported); valid, classes and canvas masks identical to "
        f"detect_canvas_batch; max abs diff {diffs} (tolerances boxes 1e-3, scores 1e-6, "
        f"masks 1e-5); launches {sub['launches']}")
    if diffs["boxes"] > 1e-3 or diffs["scores"] > 1e-6 or diffs["masks"] > 1e-5:
        raise AssertionError("exported: floats differ from detect_canvas_batch beyond tolerance")
    # request times, exported against eager, interleaved in this process: one
    # warm-up each, then N_TIMED pairs, the order alternating by pair
    exported = load_exported(path)
    calls = {"exported": lambda: exported(canvases, infos),
             "eager": lambda: pipe.detect_canvas_batch(canvases, infos)}
    ms = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    for j in range(N_TIMED):
        for name in (("exported", "eager") if j % 2 == 0 else ("eager", "exported")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    del exported, calls
    pct = {name: np.percentile(v, [10, 50, 90]) for name, v in ms.items()}
    log(f"request of 4 canvases, {N_TIMED} interleaved pairs on {device_label}: "
        + "; ".join(f"{name} median {p[1]:.3f} ms (p10 {p[0]:.3f}, p90 {p[2]:.3f}, min "
                    f"{min(ms[name]):.3f}, max {max(ms[name]):.3f})" for name, p in pct.items())
        + f"; exported/eager median {pct['exported'][1] / pct['eager'][1] - 1:+.2%}")

    # (iv) ExportedPipeline.detect against MNCPipeline.detect
    t0 = time.perf_counter()
    single = ExportedPipeline(export_inference(model, pipe.post))
    t_single = time.perf_counter() - t0
    a, b = single.detect(images[0]), pipe.detect(images[0])
    if set(a) != set(b) or not all(np.array_equal(a[k], b[k]) for k in b):
        raise AssertionError("ExportedPipeline.detect differs from MNCPipeline.detect")
    log(f"ExportedPipeline.detect of image 0 ({images[0].shape[0]}x{images[0].shape[1]}): every "
        f"key equal to MNCPipeline.detect ({int(b['valid'].sum())} valid); single-image "
        f"export + load {t_single:.1f} s")
    return by_path


@contextlib.contextmanager
def cfg_restored():
    from mnc_tpu_torch import config as C

    saved = C.cfg.clone()
    try:
        yield C.cfg
    finally:
        C.cfg.clear()
        C.cfg.update(saved)


def small_detect_many_agrees():
    """A small f32 VGG-16 model through detect_many on the card and on the
    CPU (plain versions of every kernel), on mixed sizes of both
    orientations: selections identical, boxes 1e-3 px, scores 1e-5, soft
    masks 1e-4, full masks differing on < 1e-3 of the pixels; and on the
    card, one ``detect`` against its detect_many result, to the same
    tolerances."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(canvas=(64, 96), anchor_scales=(1, 2, 4), num_classes=4, mask_size=9,
                   warp_hw=4, n_stages=5, compute_dtype=torch.float32, fc_dim=32,
                   mask_fc_dim=16, pre_nms_top_n=32, post_nms_top_n=8, rpn_min_size=2.0)
    rs = np.random.RandomState(2)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((60, 120), (120, 60), (50, 100), (48, 96), (100, 55))]
    out = {}
    with cfg_restored() as cfg:
        cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (48,), 96
        for dev in ("cuda", "cpu"):
            pipe = MNCPipeline(MNC(arch, device=dev, seed=3),
                               PostCfg(dets_per_class=4, max_per_image=6, vote_top_k=8))
            out[dev] = pipe.detect_many(images, batch_size=2)
            if dev == "cuda":  # one image alone against the stream, on the card
                singles = [pipe.detect(images[j]) for j in (0, 1)]
    worst = {"boxes": 0.0, "scores": 0.0, "masks": 0.0, "full_masks": 0.0}
    for g, c in zip(out["cuda"], out["cpu"]):
        if not (np.array_equal(g["valid"], c["valid"]) and np.array_equal(g["classes"],
                                                                          c["classes"])):
            raise AssertionError("small detect_many: selections differ between card and CPU")
        for key in ("boxes", "scores", "masks"):
            worst[key] = max(worst[key], float(np.abs(g[key] - c[key]).max()))
        worst["full_masks"] = max(worst["full_masks"],
                                  float((g["full_masks"] != c["full_masks"]).mean()))
    log(f"small f32 detect_many (5 images, both orientations), card vs CPU: selections "
        f"identical; max abs diff {worst} (tolerances boxes 1e-3, scores 1e-5, masks 1e-4, "
        f"full-mask pixel share 1e-3)")
    single = {"boxes": 0.0, "scores": 0.0, "masks": 0.0, "full_masks": 0.0}
    for j, one in zip((0, 1), singles):
        want = out["cuda"][j]
        if not (np.array_equal(one["valid"], want["valid"])
                and np.array_equal(one["classes"], want["classes"])):
            raise AssertionError("small detect_many: detect's selections differ on the card")
        for key in ("boxes", "scores", "masks"):
            single[key] = max(single[key], float(np.abs(one[key] - want[key]).max()))
        single["full_masks"] = max(single["full_masks"],
                                   float((one["full_masks"] != want["full_masks"]).mean()))
    log(f"small f32 detect of images 0 and 1 vs their detect_many results on the card: "
        f"selections identical; max abs diff {single}")
    for diffs in (worst, single):
        if (diffs["boxes"] > 1e-3 or diffs["scores"] > 1e-5 or diffs["masks"] > 1e-4
                or diffs["full_masks"] > 1e-3):
            raise AssertionError("small detect_many: results disagree beyond tolerance")


def test_net_agrees(tmp):
    """The port's test_net on synthetic_8 with one npz (a small f32 model),
    on the card and on the CPU: the same AP table."""
    import io

    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.tools import test_net
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz

    small = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32"]
    arch = MNCArch(canvas=(128, 160), num_classes=6, anchor_scales=(2, 4, 8), rpn_min_size=4.0,
                   fc_dim=64, mask_fc_dim=32, compute_dtype=torch.float32)
    npz = os.path.join(tmp, "synthetic.npz")
    save_npz(npz, jax_params_from_state_dict(MNC(arch, device="cpu", seed=1).state_dict()),
             {"bbox_pred_normalized": True})
    tables = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with cfg_restored(), contextlib.redirect_stdout(buf):
            test_net.main(["--imdb", "synthetic_8", "--npz", npz, "--device", dev,
                           "--eval-batch", "4", "--set", *small])
        lines = buf.getvalue().splitlines()
        start = next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~"))
        tables[dev] = "\n".join(lines[start:])
        log(f"test_net synthetic_8 on {dev}: {time.perf_counter() - t0:.1f} s; {lines[-1]}")
    if tables["cuda"] != tables["cpu"]:
        raise AssertionError("test_net: the AP tables of the card and the CPU differ:\n"
                             + tables["cuda"] + "\n---\n" + tables["cpu"])
    log("test_net synthetic_8: the AP tables of the card and the CPU are identical "
        f"({len(tables['cpu'].splitlines())} lines)")


# ---------------------------------------------------------------------------
# phase 4h: the CFM model family
# ---------------------------------------------------------------------------

CFM_K_SERVE, CFM_K_TRAIN, CFM_IMAGES = 300, 64, 8  # test_net's and train_net's top-k


def cfm_imdb():
    """Eight 640x1024 synthetic shapes images (5 shape classes, 2-5
    instances each): the data of both CFM paths."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB

    return SyntheticIMDB(canvas_hw=CANVAS, num_classes=6, max_gt=32, num_images=CFM_IMAGES,
                         seed=21, n_range=(2, 5))


def cfm_segdb(root, imdb, k=CFM_K_SERVE, seed=0):
    """A segdb of ``k`` segments per image of ``imdb``: MCG files written
    for each image, then the port's ``prepare_mcg_maskdb``, one process per
    image, all at once (each walks ~300 candidate masks over a 640x1024
    map).  Superpixels: a grid of 64 px cells at a seeded offset, with each
    gt instance's full mask painted over it as a superpixel of its own.
    Candidates: every gt instance first, then seeded unions of 1-4 x 1-4
    neighbouring cells, k + 16 in all (an instance that later ones cover
    whole is an empty candidate, which the converter skips); each record
    must keep at least k.  Returns the segdb directory."""
    from scipy.io import savemat

    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    h, w = imdb.gen.canvas_hw
    cell, n_cand = 64, k + 16
    rows, cols = h // cell + 1, w // cell + 1
    mcg, out = os.path.join(root, "mcg"), os.path.join(root, "segdb")
    os.makedirs(mcg)
    yy, xx = np.mgrid[0:h, 0:w]
    procs = []
    for i in imdb.image_index:
        oy, ox = rs.randint(0, cell, 2)
        sp = (1 + ((yy + oy) // cell) * cols + (xx + ox) // cell).astype(np.int32)
        labels = []
        for j, m in enumerate(imdb.gen.full_masks(i)):
            sp[m > 0.5] = 100000 + j
            labels.append([100000 + j])
        while len(labels) < n_cand:
            r0, c0 = rs.randint(0, rows), rs.randint(0, cols)
            nh, nw = rs.randint(1, 5, 2)
            labels.append([1 + r * cols + c for r in range(r0, min(r0 + nh, rows))
                           for c in range(c0, min(c0 + nw, cols))])
        cand = np.empty((len(labels), 1), object)
        for j, ids in enumerate(labels):
            cand[j, 0] = np.array([ids], np.float64)
        savemat(os.path.join(mcg, f"{i}.mat"), {"superpixels": sp, "labels": cand})
        image_list = os.path.join(root, f"list_{i}.txt")
        with open(image_list, "w") as f:
            f.write(f"{i}\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mnc_tpu_torch.tools.prepare_mcg_maskdb", "--mcg-dir", mcg,
             "--image-list", image_list, "--out", out, "--mask-size", "21", "--top-k",
             str(n_cand)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        for p in procs:
            text, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"prepare_mcg_maskdb failed:\n{text}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"cfm segdb: {len(procs)} images x {n_cand} MCG candidates converted by "
        f"prepare_mcg_maskdb ({len(procs)} processes) in {time.perf_counter() - t0:.1f} s")
    return out


def cfm_serve_path(device_label, arch, imdb, segdb, n_images=None, name="cfm_serve"):
    """``cfm_detect`` at full width (phase 4a's VGG-16, bf16, seeded init;
    or another ``arch``: a ResNet's FrozenBN leaves are drawn at random) on
    the first ``n_images`` images (all 8 by default), each with its 300
    segments, after one warm-up image.  The detections' arrays must be
    finite, some valid, and every valid detection's box one of the image's
    refined segment boxes.  Returns the launch counts of those images."""
    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.data.loader import load_segments
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.cfm import cfm_apply, cfm_detect
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import PostCfg

    model = MNC(arch, device="cuda", seed=0)
    if arch.trunk != "vgg16":  # at init every block is its shortcut
        randomize_frozen_bn(model, 4)
    post = PostCfg.from_cfg()
    inputs = []
    for i in imdb.image_index[:n_images]:
        ex = imdb.example(i)
        boxes, masks, valid, nseg = load_segments(segdb, i, CFM_K_SERVE, cfg.MASK_SIZE)
        if nseg != CFM_K_SERVE:
            raise AssertionError(f"cfm segdb: image {i} has {nseg} < {CFM_K_SERVE} segments")
        inputs.append(tuple(torch.from_numpy(x).cuda() for x in
                            (ex["image"], ex["im_info"], boxes * float(ex["im_info"][2]), masks,
                             valid)))
    cfm_detect(model, *inputs[-1], post)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, dets = [], []
    for x in inputs:
        t0 = time.perf_counter()
        out = cfm_detect(model, *x, post)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        for key in ("boxes", "scores", "masks"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{name}: {key} is not finite")
        if out["canvas_masks"].shape != (post.max_per_image, *arch.canvas):
            raise AssertionError(f"{name}: canvas masks {tuple(out['canvas_masks'].shape)}")
        dets.append((out["boxes"][out["valid"]].cpu(), int(out["valid"].sum())))
        del out
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # every valid detection's box is a refined segment box (after the count)
    worst = 0.0
    for x, (boxes, n_valid) in zip(inputs, dets):
        if n_valid == 0:
            raise AssertionError(f"{name}: an image has no valid detection")
        refined = cfm_apply(model, *x)["boxes"][x[4]].cpu()
        worst = max(worst, (boxes[:, None] - refined[None]).abs().amax(-1).min(1).values.max()
                    .item())
    if not worst <= 1e-3:
        raise AssertionError(f"{name}: a detection box is {worst} px from every refined "
                             "segment box")
    ms = sorted(x * 1e3 for x in lat)
    log(f"{name}: launches {counts}; valid detections per image {[n for _, n in dets]}; "
        f"every one a refined segment box (max diff {worst:.1e} px); peak memory {peak:.2f} GiB")
    log(f"{name} on {device_label}: ms per image (1 image, {CFM_K_SERVE} segments, "
        f"{arch.num_classes} classes, trunk {arch.trunk}, roi_conv5 {arch.roi_conv5}, int8 "
        f"{arch.int8_inference}) median {float(np.median(ms)):.2f}, worst {ms[-1]:.2f} "
        f"(all: {', '.join(f'{x * 1e3:.2f}' for x in lat)})")
    busy, n_kernels, top, _ = traced(lambda: [cfm_detect(model, *x, post) for x in inputs])
    log(f"{name} traced on {device_label}: device busy {busy / len(inputs):.3f} ms per image "
        f"({n_kernels / len(inputs):.0f} kernels) of the untraced median "
        f"{float(np.median(ms)):.2f} ms (idle share {1 - busy / sum(ms):.3f}); top kernels: "
        + top)
    del model
    return counts


def cfm_train_path(device_label, imdb, segdb):
    """The CFM train step at full width: ``MNCArch.from_cfg(train=True)``
    (f32 masters, blocks 1-2 frozen, 128 RoIs, MAX_GT 32), 2 images a step
    from ``TrainLoader`` (flips on, top 64 segments), one warm-up step, 3
    timed ones and a traced one.  The losses must be finite, the trunk's conv and the fc
    and cls parameters must move, and every RPN and mask-head parameter
    must be what decay alone makes of it (the solver's recurrence for a
    zero gradient, bit for bit).  Returns the launch counts of the 3 steps."""
    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.data.loader import TrainLoader
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.cfm import make_cfm_train_step
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.train.loop import TrainState, train_cfg_from_cfg
    from mnc_tpu_torch.train.optim import make_optimizer

    arch = MNCArch.from_cfg(train=True)
    assert (arch.canvas, arch.fc_dim, arch.trunk_frozen, cfg.TRAIN.BATCH_SIZE,
            cfg.STATIC.MAX_GT) == (CANVAS, 4096, 2, 128, 32), arch
    model = MNC(arch, device="cuda", seed=0, train=True)
    opt = make_optimizer(model, base_lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
                         weight_decay=cfg.TRAIN.WEIGHT_DECAY, gamma=cfg.TRAIN.GAMMA,
                         stepsize=cfg.TRAIN.STEPSIZE, clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
    step = make_cfm_train_step(model, opt, arch,
                               dict(train_cfg_from_cfg(cfg), CFM_IOU=cfg.TRAIN.CFM_IOU))
    state = TrainState.create(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = TrainLoader(imdb, canvas_hw=arch.canvas, ims_per_batch=2, seed=3,
                         segdb_dir=segdb, seg_top_k=CFM_K_TRAIN)
    gen = torch.Generator(device="cuda").manual_seed(7)
    times, lrs = [], []
    try:
        for i in range(4):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                     for k, v in next(loader).items()}
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
            lrs.append(opt.lr)
            t0 = time.perf_counter()
            _, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            m = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(list(m.values()))):
                raise AssertionError(f"cfm_train: a loss is not finite: {m}")
            log(f"cfm_train step {i} ({'warm-up' if i == 0 else 'timed'}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                 for k, v in next(loader).items()}
        lrs.append(opt.lr)
        busy, n_kernels, top, _ = traced(lambda: step(state, batch, gen))
    finally:
        loader.close()
    log(f"cfm_train traced step on {device_label}: device busy {busy:.3f} ms ({n_kernels} "
        f"kernels) of the untraced median wall {float(np.median(times[1:])) * 1e3:.1f} ms "
        f"(idle share {1 - busy / (float(np.median(times[1:])) * 1e3):.3f}); top kernels: "
        + top)
    after = dict(model.named_parameters())
    moved = [n for n, p in after.items() if not torch.equal(p, before[n])]
    for prefix in ("trunk.conv5_", "classify_head.fc6.", "classify_head.cls_score."):
        if not any(n.startswith(prefix) for n in moved):
            raise AssertionError(f"cfm_train: no {prefix} parameter moved")
    no_grad = [n for n in after if n.startswith(("rpn_head.", "mask_head."))]
    for n in no_grad:
        w, t = before[n].clone(), torch.zeros_like(before[n])
        for lr in lrs:
            g = torch.zeros_like(w)
            g = g * 2.0 if n.endswith("bias") else g.add(w, alpha=opt.weight_decay)
            t.mul_(opt.momentum).add_(g)
            w.add_(t, alpha=-lr)
        if not torch.equal(after[n].detach(), w):
            raise AssertionError(f"cfm_train: {n} moved otherwise than by decay alone")
    log(f"cfm_train: launches {counts}; {len(no_grad)} RPN and mask-head parameters moved by "
        f"decay alone (bit-equal to the solver's zero-gradient recurrence); peak memory "
        f"{peak:.2f} GiB")
    log(f"cfm_train on {device_label}: wall ms per step of 2 images (K = {CFM_K_TRAIN} "
        f"segments + MAX_GT 32, 128 RoIs each) "
        + ", ".join(f"{x * 1e3:.1f}" for x in times[1:]) + f" (warm-up {times[0] * 1e3:.1f})")
    del model, opt, state
    return counts


CFM_SMALL = dict(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                 warp_hw=4, compute_dtype=torch.float32, fc_dim=64, mask_fc_dim=32,
                 pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0)


def _cfm_small_segments(rs, n, n_valid, hw, s=9):
    h, w = hw
    xy = np.stack([rs.uniform(0, w * 0.6, n), rs.uniform(0, h * 0.6, n)], 1)
    boxes = np.concatenate([xy, np.minimum(xy + rs.uniform(10, 60, (n, 2)),
                                           [w - 1, h - 1])], 1).astype(np.float32)
    masks = (rs.uniform(size=(n, s, s)) > 0.4).astype(np.float32)
    valid = np.arange(n) < n_valid
    return boxes, masks, valid


def small_cfm_detect_agrees():
    """A small f32 model's cfm_detect on the card against the same model on
    the CPU (plain versions of every kernel), 2 images of 40 segments:
    selections identical, boxes 1e-2 px, scores 1e-4, soft masks 1e-3,
    canvas pixels differing < 1e-3 (small_model_agrees' tolerances)."""
    from mnc_tpu_torch.models.cfm import cfm_detect
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import PostCfg

    arch = MNCArch(**CFM_SMALL)
    post = PostCfg(dets_per_class=4, max_per_image=8)
    rs = np.random.RandomState(5)
    cases = [(rs.randint(0, 256, (96, 128, 3)).astype(np.uint8),
              np.array([96.0, 128.0, 1.0], np.float32), *_cfm_small_segments(rs, 40, 32, (96, 128)))
             for _ in range(2)]
    out = {dev: [cfm_detect(MNC(arch, device=dev, seed=3), *c, post) for c in cases]
           for dev in ("cuda", "cpu")}
    worst = {"boxes": 0.0, "scores": 0.0, "masks": 0.0, "canvas": 0.0}
    for g, c in zip(out["cuda"], out["cpu"]):
        for key in ("valid", "classes"):
            if not torch.equal(g[key].cpu(), c[key]):
                raise AssertionError(f"small cfm_detect: {key} differs between card and CPU")
        for key in ("boxes", "scores", "masks"):
            worst[key] = max(worst[key], (g[key].cpu() - c[key]).abs().max().item())
        worst["canvas"] = max(worst["canvas"], (g["canvas_masks"].cpu() != c["canvas_masks"])
                              .float().mean().item())
    log(f"small f32 cfm_detect (2 images x 40 segments), card vs CPU: selections identical; "
        f"max abs diff {worst} (tolerances boxes 1e-2, scores 1e-4, masks 1e-3, canvas pixel "
        "share 1e-3)")
    if (worst["boxes"] > 1e-2 or worst["scores"] > 1e-4 or worst["masks"] > 1e-3
            or worst["canvas"] > 1e-3):
        raise AssertionError("small cfm_detect: card and CPU disagree beyond tolerance")


def small_cfm_train_step_agrees():
    """One CFM train step of a small f32 model (blocks unfrozen) on the card
    against the CPU on the same draws: sampled RoIs and labels identical,
    losses 1e-4 relative, gradients 1e-3 (RPN and heads) and 0.15 (trunk)
    of each leaf's max (small_train_step_agrees' tolerances and reasons)."""
    from mnc_tpu_torch.data.synthetic import SyntheticShapes
    from mnc_tpu_torch.models import cfm
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.train import targets as T
    from mnc_tpu_torch.train.loop import CfmDraws, draw_cfm_randoms

    arch = MNCArch(**dict(CFM_SMALL, canvas=(128, 160), trunk_frozen=0))
    train_cfg = dict(BATCH_SIZE=32, FG_FRACTION=0.25, FG_THRESH=0.5, BG_THRESH_HI=0.5,
                     BG_THRESH_LO=0.0)
    data = SyntheticShapes(canvas_hw=arch.canvas, num_classes=4, max_gt=4, gt_mask_size=16,
                           n_range=(1, 3), seed=7)
    batch = {k: torch.from_numpy(v) for k, v in data.batch([0, 1]).items()}
    rs = np.random.RandomState(8)
    segs = [_cfm_small_segments(rs, 24, 20, arch.canvas) for _ in range(2)]
    for i in range(2):  # half the segments jitter around the gt boxes
        gt = batch["gt_boxes"][i][batch["gt_valid"][i]].numpy()
        segs[i][0][:12] = gt[rs.randint(0, len(gt), 12)] + rs.uniform(-4, 4, (12, 4))
    for j, key in enumerate(("seg_boxes", "seg_masks", "seg_valid")):
        batch[key] = torch.from_numpy(np.stack([s[j] for s in segs]))
    draws = draw_cfm_randoms(torch.Generator().manual_seed(9), arch, train_cfg, 2, 24, 4)
    picked, res = {}, {}
    orig = T.cfm_targets

    def spy(*a, **kw):
        out = orig(*a, **kw)
        picked.setdefault(out.rois.device.type, []).append((out.rois.cpu(), out.labels.cpu()))
        return out

    T.cfm_targets = spy
    try:
        for dev in ("cuda", "cpu"):
            model = MNC(arch, device=dev, seed=3, train=True)
            d = CfmDraws(*(tuple(x.to(dev) for x in f) for f in draws))
            total, losses = cfm.cfm_loss(model, {k: v.to(dev) for k, v in batch.items()}, d,
                                         arch, train_cfg)
            total.backward()
            res[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None})
    finally:
        T.cfm_targets = orig
    for (gr, gl), (cr, cl) in zip(picked["cuda"], picked["cpu"]):
        if not (torch.equal(gl, cl) and torch.equal(gr, cr)):
            raise AssertionError("small cfm train step: sampled RoIs or labels differ")
    if set(res["cuda"][1]) != set(res["cpu"][1]):
        raise AssertionError("small cfm train step: different parameters got gradients")
    loss_err = max(abs(res["cuda"][0][k] - v) / max(abs(v), 1e-6)
                   for k, v in res["cpu"][0].items())
    errs = {"trunk": 0.0, "heads": 0.0}
    for n, g in res["cpu"][1].items():
        err = ((res["cuda"][1][n] - g).abs().max() / g.abs().max().clamp_min(1e-12)).item()
        part = "trunk" if n.startswith("trunk.") else "heads"
        errs[part] = max(errs[part], err)
    log(f"small f32 CFM train step, card vs CPU: sampled RoIs and labels identical; max "
        f"relative loss diff {loss_err:.2e} (tolerance 1e-4); max gradient diff relative to "
        f"each leaf's max: heads {errs['heads']:.2e} (tolerance 1e-3), trunk "
        f"{errs['trunk']:.2e} (tolerance 0.15)")
    if loss_err > 1e-4 or errs["heads"] > 1e-3 or errs["trunk"] > 0.15:
        raise AssertionError("small cfm train step: card and CPU disagree beyond tolerance")


def test_net_segdb_agrees(tmp):
    """The port's ``test_net --segdb`` on synthetic_8 with its gt as the
    segdb (a small f32 model), on the card and on the CPU: the same AP
    table."""
    import io
    import pickle

    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.tools import test_net
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz

    segdb = os.path.join(tmp, "oracle_segdb")
    os.makedirs(segdb)
    imdb = SyntheticIMDB(num_images=8)
    for i, (entry, masks) in enumerate(zip(imdb.roidb(), imdb.maskdb())):
        with open(os.path.join(segdb, f"{i}.pkl"), "wb") as f:
            pickle.dump({"index": i, "boxes": entry["boxes"], "masks": masks["masks"]}, f)
    small = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32"]
    arch = MNCArch(canvas=(128, 160), num_classes=6, anchor_scales=(2, 4, 8), rpn_min_size=4.0,
                   fc_dim=64, mask_fc_dim=32, compute_dtype=torch.float32)
    npz = os.path.join(tmp, "cfm_small.npz")
    save_npz(npz, jax_params_from_state_dict(MNC(arch, device="cpu", seed=2).state_dict()),
             {"bbox_pred_normalized": True})
    tables = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with cfg_restored(), contextlib.redirect_stdout(buf):
            test_net.main(["--imdb", "synthetic_8", "--npz", npz, "--device", dev, "--segdb",
                           segdb, "--set", *small])
        lines = buf.getvalue().splitlines()
        start = next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~"))
        tables[dev] = "\n".join(lines[start:])
        log(f"test_net --segdb synthetic_8 on {dev}: {time.perf_counter() - t0:.1f} s; "
            f"{lines[-1]}")
    if tables["cuda"] != tables["cpu"]:
        raise AssertionError("test_net --segdb: the AP tables of the card and the CPU differ:\n"
                             + tables["cuda"] + "\n---\n" + tables["cpu"])
    log("test_net --segdb synthetic_8: the AP tables of the card and the CPU are identical")


# ---------------------------------------------------------------------------
# phase 4i: int8 serving (TEST.INT8)
# ---------------------------------------------------------------------------

N_INT8_REQUESTS = 10  # request pairs timed, int8 and bf16 interleaved
# the int8 / bf16 request-time ratio predicted in PERF.md before the run that tests it;
# printed beside the measured ratio, not gated
INT8_RATIO_PREDICTED = (0.88, 0.94)


def _tracks(name, got, want):
    """An int8 cascade's cls_prob against the float one's, RoI index by RoI
    index over the RoIs valid in both, with ``tests/test_quant.py``'s
    measures (correlation, its gate > 0.995; max |delta|, its gate < 0.05).
    Reported, not gated: at full width with seeded random weights the two
    cascades propose different RoIs at the same index (the trunk error
    reorders near-tied proposals among 6000), so index-wise scores compare
    different boxes; ``small_int8_model_agrees`` and the audit's head
    isolation (the same features and RoIs) hold the int8 path instead."""
    both = got["roi_valid"] & want["roi_valid"]
    g = got["cls_prob"][both].float().cpu().numpy().ravel()
    w = want["cls_prob"][both].float().cpu().numpy().ravel()
    same = (got["rois"] == want["rois"]).all(-1) & both
    corr = float(np.corrcoef(g, w)[0, 1])
    dmax = float(np.abs(g - w).max())
    log(f"int8 {name}: cls_prob against the bf16 cascade's on the same canvases, index by "
        f"index over {int(both.sum())} RoIs valid in both ({int(same.sum())} of them the "
        f"same box): correlation {corr:.6f} (the JAX test's gate at its small size: > 0.995), "
        f"max |delta| {dmax:.4e} (there: < 0.05)")


def small_int8_model_agrees(arch_kw=None):
    """A small f32 int8 model on the card (kernel E) against the same weights
    on the CPU (the plain version, bit-identical to the JAX package): the
    int8 layers agree bit for bit (phase 3), the float layers sum in other
    orders, and a RoI feature that moves by an ulp can move one int8 value
    of a per-RoI dense layer by a step, so the scores are held within 1e-3
    (the CPU test's bound against JAX), boxes within 1e-2 px, mask
    probabilities within 2e-3, with identical selections."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    arch = MNCArch(canvas=(96, 128), anchor_scales=(2, 4, 8), num_classes=4, mask_size=9,
                   warp_hw=4, compute_dtype=torch.float32, fc_dim=64, mask_fc_dim=32,
                   pre_nms_top_n=64, post_nms_top_n=16, rpn_min_size=4.0,
                   int8_inference=True, **(arch_kw or {}))
    post = PostCfg(dets_per_class=4, max_per_image=8)
    g = torch.Generator().manual_seed(2)
    imgs = torch.randint(0, 256, (2, 96, 128, 3), generator=g, dtype=torch.uint8)
    infos = torch.tensor([[96.0, 128.0, 1.0], [80.0, 120.0, 1.0]])
    out = {}
    for dev in ("cuda", "cpu"):
        model = MNC(arch, device=dev, seed=3)
        if arch.trunk != "vgg16":
            randomize_frozen_bn(model, 4)
        out[dev] = MNCPipeline(model, post).detect_canvas_batch(imgs, infos)
    gpu, cpu = out["cuda"], out["cpu"]
    for key in ("valid", "classes"):
        if not torch.equal(gpu[key].cpu(), cpu[key]):
            raise AssertionError(f"small int8 model: {key} differs between card and CPU")
    errs = {key: (gpu[key].cpu() - cpu[key]).abs().max().item()
            for key in ("boxes", "scores", "masks")}
    log(f"small f32 int8 model ({arch.trunk}, roi_conv5 {arch.roi_conv5}), card vs CPU: "
        f"selections identical ({int(cpu['valid'].sum())} valid); max abs diff {errs}")
    if errs["boxes"] > 1e-2 or errs["scores"] > 1e-3 or errs["masks"] > 2e-3:
        raise AssertionError("small int8 model: card and CPU disagree beyond tolerance")


def int8_serve_path(device_label, arch):
    """Phase 4i on phase 4a's VGG-16 (bf16, seeded init): the int8 model
    (``int8_inference``; its int8 layers' weights the same f32 values that the
    bf16 model rounds) against the bf16 one on the same canvases.  Returns the
    launch counts of the int8 requests alone (the counts are zeroed before
    each of them and read after it)."""
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg
    from mnc_tpu_torch.tools.int8_audit import audit, synthetic_images

    models = {"bf16": MNC(arch, device="cuda", seed=0),
              "int8": MNC(dataclasses.replace(arch, int8_inference=True), device="cuda",
                          seed=0)}
    post = PostCfg.from_cfg(dets_per_class=16)
    pipes = {k: MNCPipeline(m, post) for k, m in models.items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    reqs = [torch.randint(0, 256, (b, *arch.canvas, 3), generator=g, device="cuda",
                          dtype=torch.uint8) for _ in range(N_INT8_REQUESTS)]
    infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * b,
                         device="cuda")
    for pipe in pipes.values():  # warm-up: cuDNN plans, the int8 weights quantized once
        pipe.detect_canvas_batch(reqs[-1], infos)
    torch.cuda.synchronize()
    lat = {k: [] for k in pipes}
    counts: dict = {}
    for r in reqs:
        for k, pipe in pipes.items():
            if k == "int8":
                reset_launch_counts()
            t0 = time.perf_counter()
            out = pipe.detect_canvas_batch(r, infos)
            torch.cuda.synchronize()
            lat[k].append((time.perf_counter() - t0) * 1e3)
            if k == "int8":
                for name, c in launch_counts().items():
                    counts[name] = counts.get(name, 0) + c
            _check_serving(out, arch, b, post.max_per_image)
            del out
    log(f"serve VGG-16 int8: launches over {N_INT8_REQUESTS} requests {counts}; per request "
        f"E {counts['gemm_s8_cuda'] / N_INT8_REQUESTS:g}, F "
        f"{counts['quant_act_cuda'] / N_INT8_REQUESTS:g}")
    for k, ms in lat.items():
        log(f"serve VGG-16 {k} on {device_label}: per request of {b} canvases median "
            f"{float(np.median(ms)):.2f} ms, worst {max(ms):.2f} ms over {len(ms)} "
            f"(interleaved with the other dtype): " + ", ".join(f"{x:.1f}" for x in ms))
    log(f"serve VGG-16: int8 median / bf16 median = "
        f"{float(np.median(lat['int8'])) / float(np.median(lat['bf16'])):.3f} (predicted "
        f"{INT8_RATIO_PREDICTED[0]}-{INT8_RATIO_PREDICTED[1]})")
    with torch.inference_mode():
        nets = {k: m.apply_batch(reqs[0], infos) for k, m in models.items()}
    _tracks("VGG-16", nets["int8"], nets["bf16"])

    # the activation scale covers the batch: an image alone against the same
    # image beside three wide-range batchmates (the reference's behaviour)
    rs = np.random.RandomState(3)
    quiet = rs.randint(118, 138, (480, 640, 3)).astype(np.uint8)
    loud = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(3)]
    for k, pipe in pipes.items():
        alone = pipe.detect(quiet)
        batched = pipe.detect_many([quiet, *loud], batch_size=4)[0]
        n = min(len(alone["scores"]), len(batched["scores"]))
        ds = float(np.abs(alone["scores"][:n] - batched["scores"][:n]).max()) if n else 0.0
        same_boxes = bool(n and np.array_equal(alone["boxes"][:n], batched["boxes"][:n]))
        with torch.inference_mode():
            canv = torch.as_tensor(np.stack([quiet, *loud]), device="cuda")
            canv = torch.nn.functional.pad(canv, (0, 0, 0, arch.canvas[1] - 640, 0,
                                                  arch.canvas[0] - 480))
            f4 = models[k].features(canv)[0].float()
            f1 = models[k].features(canv[:1])[0].float()
        df = ((f4 - f1).abs().max() / f1.abs().max()).item()
        log(f"int8 batch scale, {k}: detect(image) against detect_many([image, 3 wide-range "
            f"batchmates])[0]: {len(alone['scores'])} / {len(batched['scores'])} detections, "
            f"max |delta score| over the first {n} {ds:.4e}, boxes identical {same_boxes}; "
            f"trunk features of the padded canvas alone against in the batch: max |delta| "
            f"{df:.4e} of their max")
        if k == "int8" and df == 0.0:
            raise AssertionError("int8: an image's features do not depend on its batch")

    # the audit, each image on its own as the JAX tool runs it
    t0 = time.perf_counter()
    rec = audit(models["bf16"], models["int8"], *synthetic_images(arch, 4))
    log(f"int8_audit VGG-16 (phase 4a's arch, seeded weights, 4 synthetic 640x1024 images, "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(rec)}")
    return counts


@contextlib.contextmanager
def quantize_twice():
    """ResNet bottlenecks whose conv1 and proj quantize their shared input
    each on its own, as before they shared one quantization: with no
    quantized input to hand over, each ConvInt8 quantizes its own."""
    from mnc_tpu_torch.ops.quant import ConvInt8

    saved = ConvInt8.quantize
    ConvInt8.quantize = lambda self, x: None
    try:
        yield
    finally:
        ConvInt8.quantize = saved


def shared_quantization_agrees(name, model, canv, infos, nets):
    """An int8 ResNet's cascade outputs (``nets``, from ``apply_batch``) and
    its detections with one quantization for a bottleneck's conv1 and proj,
    against the same with each quantizing on its own: bit for bit."""
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    pipe = MNCPipeline(model, PostCfg.from_cfg(dets_per_class=16))
    with torch.inference_mode():
        dets = pipe.detect_canvas_batch(canv, infos)
        with quantize_twice():
            twice = model.apply_batch(canv, infos)
            dets_twice = pipe.detect_canvas_batch(canv, infos)
    same = all(torch.equal(nets[k], twice[k]) for k in nets) and \
        all(torch.equal(dets[k], dets_twice[k]) for k in dets)
    log(f"int8 ResNet-101 COCO ({name}): the cascade's outputs and detections with one "
        f"quantization shared by each first block's conv1 and proj, against each quantizing "
        f"on its own: bit-identical {same}")
    if not same:
        raise AssertionError(f"ResNet-101 int8 ({name}): the shared quantization changed "
                             f"the outputs")


N_RESNET_INT8_REQUESTS = 6  # ResNet-101 request pairs timed, int8 and bf16 interleaved


def int8_against_bf16(name, device_label, models, canv, infos, n):
    """``n`` requests of the int8 model (``models[True]``) and the bf16 one
    on the same canvases, interleaved after a warm-up: median and worst ms
    each and their ratio (host clock, each ending in a synchronize)."""
    from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

    pipes = {q: MNCPipeline(m, PostCfg.from_cfg(dets_per_class=16)) for q, m in models.items()}
    for pipe in pipes.values():
        pipe.detect_canvas_batch(canv, infos)
    lat = {q: [] for q in pipes}
    for _ in range(n):
        for q, pipe in pipes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.detect_canvas_batch(canv, infos)
            torch.cuda.synchronize()
            lat[q].append((time.perf_counter() - t0) * 1e3)
    med = {q: float(np.median(v)) for q, v in lat.items()}
    log(f"serve {name} on {device_label}: int8 median {med[True]:.2f} ms (worst "
        f"{max(lat[True]):.2f}), bf16 median {med[False]:.2f} ms (worst {max(lat[False]):.2f}) "
        f"over {n} interleaved requests of {canv.shape[0]} canvases; int8 / bf16 = "
        f"{med[True] / med[False]:.3f}")


def int8_resnet_paths(device_label):
    """Phase 4i on the ResNet-101 COCO configuration, conv5 and fc heads,
    with ``TEST.INT8``: one request each through ``serve_path`` (phase 4d's
    checks and counts), and cls_prob against the bf16 cascade's."""
    from mnc_tpu_torch import config as C
    from mnc_tpu_torch.models.mnc import MNC, MNCArch

    by_path = {}
    for roi_conv5, name in ((True, "resnet101_conv5"), (False, "resnet101_fc")):
        with coco_cfg(roi_conv5):
            C.cfg_from_list(["TEST.INT8", "True"])
            arch = MNCArch.from_cfg()
            assert arch.int8_inference and arch.trunk == "resnet101", arch
            by_path[f"serve_int8_{name}"] = c = serve_path(
                device_label, f"ResNet-101 COCO int8 ({name})", arch, 1)
            # the first block of stages 2-4, and of stage 5 in each of the two head passes,
            # quantizes its input once for conv1 and proj
            shared = 3 + (2 if roi_conv5 else 0)
            log(f"ResNet-101 COCO int8 ({name}): kernel F {c['quant_act_cuda']} launches a "
                f"request, E {c['gemm_s8_cuda']} ({shared} inputs shared by two int8 layers)")
            if c["quant_act_cuda"] != c["gemm_s8_cuda"] - shared:
                raise AssertionError(f"ResNet-101 int8 ({name}): F launched "
                                     f"{c['quant_act_cuda']} times for E's {c['gemm_s8_cuda']}")
            g = torch.Generator(device="cuda").manual_seed(5)
            canv = torch.randint(0, 256, (4, *arch.canvas, 3), generator=g, device="cuda",
                                 dtype=torch.uint8)
            infos = torch.tensor([[float(arch.canvas[0]), float(arch.canvas[1]), 1.0]] * 4,
                                 device="cuda")
            # random FrozenBN leaves: at init each block is its shortcut
            models = {q: randomize_frozen_bn(MNC(dataclasses.replace(arch, int8_inference=q),
                                                 device="cuda", seed=0), 4)
                      for q in (False, True)}
            int8_against_bf16(f"ResNet-101 COCO ({name})", device_label, models, canv, infos,
                              N_RESNET_INT8_REQUESTS)
            with torch.inference_mode():
                nets = {q: m.apply_batch(canv, infos) for q, m in models.items()}
            shared_quantization_agrees(name, models[True], canv, infos, nets[True])
            _tracks(f"ResNet-101 COCO ({name})", nets[True], nets[False])
            del nets, models
        torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# phase 4j: real-format datasets (SBD / VOC and COCO trees on disk)
# ---------------------------------------------------------------------------

VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333))  # (h, w), both orientations
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427))
# COCO's 80 category ids (1..90 less ten unused ones), so its head keeps 81 classes
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91)
                          if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
N_VOC_IMAGES, N_COCO_IMAGES = 8, 4


def _draw_instances(rs, h, w, num_classes, max_instances=4):
    """A seeded picture of 1..max_instances ellipses and rectangles over a
    noise background: (BGR uint8 image, [(class id, full bool mask)])."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (rs.uniform(0, 1, (h, w, 3)) * 60 + 90).astype(np.uint8)
    out = []
    for _ in range(rs.randint(1, max_instances + 1)):
        c = int(rs.randint(1, num_classes))
        cy, cx = rs.uniform(0.2, 0.8) * h, rs.uniform(0.2, 0.8) * w
        ry, rx = rs.uniform(0.08, 0.3) * h, rs.uniform(0.08, 0.3) * w
        if rs.uniform() < 0.5:
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:
            m = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        colour = np.array([(37 * c) % 256, (91 * c) % 256, (151 * c) % 256])
        img[m] = np.clip(colour + rs.randint(-20, 21, (int(m.sum()), 3)), 0, 255)
        for prev in out:  # a later instance covers the earlier ones
            prev[1][m] = False
        out.append((c, m))
    return img, [(c, m) for c, m in out if m.any()]


def write_sbd_tree(root, n_images=N_VOC_IMAGES, sizes=VOC_SIZES, seed=0, max_instances=4,
                   num_classes=21):
    """An SBD tree in the benchmark_RELEASE layout under ``root``, without
    cv2: per image 1..``max_instances`` instances of classes below
    ``num_classes``, the instance and class maps as ``GTinst`` / ``GTcls``
    structs (``scipy.io.savemat``), the picture as PNG bytes under the
    reference's ``img/<id>.jpg`` name, and ``train.txt`` / ``val.txt``
    listing every id.  Returns the ids."""
    from scipy.io import savemat

    from mnc_tpu_torch.utils import png

    rs = np.random.RandomState(seed)
    ds = os.path.join(root, "benchmark_RELEASE", "dataset")
    for sub in ("inst", "cls", "img"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    ids = []
    for k in range(n_images):
        h, w = sizes[k % len(sizes)]
        index = f"2008_{k:06d}"
        img, insts = _draw_instances(rs, h, w, num_classes, max_instances)
        inst = np.zeros((h, w), np.uint8)
        clsm = np.zeros((h, w), np.uint8)
        for iid, (c, m) in enumerate(insts, start=1):
            inst[m], clsm[m] = iid, c
        cats = np.array([[c] for c, _ in insts], np.float64)
        savemat(os.path.join(ds, "inst", f"{index}.mat"),
                {"GTinst": {"Segmentation": inst, "Categories": cats}})
        savemat(os.path.join(ds, "cls", f"{index}.mat"),
                {"GTcls": {"Segmentation": clsm,
                           "CategoriesPresent": np.unique(cats).astype(np.float64)}})
        png.imwrite(os.path.join(ds, "img", f"{index}.jpg"), img)
        ids.append(index)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return ids


def write_coco_tree(root, split, n_images=N_COCO_IMAGES, sizes=COCO_SIZES, seed=1,
                    category_ids=COCO_CATEGORY_IDS):
    """A COCO tree under ``root`` without cv2: ``annotations/instances_
    <split>.json`` with the given categories, every segmentation compressed
    RLE (``data.coco.encode_coco_rle``; polygons would need cv2), one crowd
    and one tiny annotation that the reader leaves out, and PNG images under
    ``images/<split>/``.  Returns the json's path."""
    import json

    from mnc_tpu_torch.data.coco import encode_coco_rle
    from mnc_tpu_torch.utils import png

    rs = np.random.RandomState(seed)
    images, anns = [], []
    for k in range(n_images):
        h, w = sizes[k % len(sizes)]
        fname = f"{split}_{k:06d}.png"
        img, insts = _draw_instances(rs, h, w, len(category_ids) + 1)
        png.imwrite(os.path.join(root, "images", split, fname), img)
        images.append({"id": 100 + k, "file_name": fname, "height": h, "width": w})
        extra = []
        if k == 0:  # a crowd region and a speck: both filtered out by COCOSeg
            crowd = np.zeros((h, w), bool)
            crowd[:20, :30] = True
            speck = np.zeros((h, w), bool)
            speck[h - 3:, w - 3:] = True
            extra = [(1, crowd, 1), (2, speck, 0)]
        for c, m, crowd in [(c, m, 0) for c, m in insts] + extra:
            ys, xs = np.nonzero(m)
            anns.append({"id": len(anns) + 1, "image_id": 100 + k,
                         "category_id": category_ids[c - 1], "iscrowd": crowd,
                         "area": float(m.sum()),
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min() + 1),
                                  float(ys.max() - ys.min() + 1)],
                         "segmentation": encode_coco_rle(m)})
    path = os.path.join(root, "annotations", f"instances_{split}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i, "name": f"category_{i}"}
                                  for i in category_ids]}, f)
    return path


def run_tool(tool, argv):
    """``mnc_tpu_torch.tools.<tool>.main(argv)`` in this process with the
    cfg restored after it: (its standard output, seconds, launch counts)."""
    import importlib
    import io

    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts

    main = importlib.import_module(f"mnc_tpu_torch.tools.{tool}").main
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with cfg_restored(), contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0:
        raise AssertionError(f"{tool} {argv} returned {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue(), seconds, counts


def _ap_table(stdout):
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("~~~~~~"))
    return "\n".join(lines[start:])


def _done(stdout):
    """train_net's closing line's step average (snapshots included)."""
    return next(ln for ln in stdout.splitlines() if ln.startswith("done:")).split("; ")[0]


def _metrics(run_dir):
    import json

    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def oracle_segdb(imdb, out):
    """A segdb (``tools/prepare_mcg_maskdb`` records) of each image's
    ground-truth instances: boxes in image coordinates, box-frame masks."""
    import pickle

    os.makedirs(out, exist_ok=True)
    for entry, masks in zip(imdb.roidb(), imdb.maskdb()):
        with open(os.path.join(out, f"{entry['index']}.pkl"), "wb") as f:
            pickle.dump({"index": entry["index"], "boxes": entry["boxes"],
                         "masks": masks["masks"]}, f)
    return out


def oracle_scores(data_dir, coco_split):
    """The ground truth fed back as detections through ``imdb.evaluate``
    scores 1.0 on both trees (the readers and the evaluator run here)."""
    from mnc_tpu_torch.data.coco import COCOSeg
    from mnc_tpu_torch.data.pascal_voc import PascalVOCSeg

    for name, imdb, threshs in (
            ("SBD", PascalVOCSeg("val", os.path.join(data_dir, "sbd"),
                                 cache_dir=os.path.join(data_dir, "cache")), (0.5, 0.7)),
            ("COCO", COCOSeg(coco_split, os.path.join(data_dir, "coco"),
                             cache_dir=os.path.join(data_dir, "cache")), (0.5, 0.7, "avg"))):
        gt = imdb.gt_instances()
        dets = [{"image_id": i, "class_id": g["class_id"], "score": 1.0, "mask": g["mask"]}
                for i, gs in gt.items() for g in gs]
        res = imdb.evaluate(dets, iou_threshs=threshs)
        maps = {t: r["map"] for t, r in res.items()}
        log(f"oracle {name} ({imdb.num_images} images, {len(dets)} instances, "
            f"{imdb.num_classes} classes): mAP^r {maps}")
        if not all(abs(v - 1.0) < 1e-9 for v in maps.values()):
            raise AssertionError(f"oracle {name}: the ground truth scores {maps}, not 1.0")


# the bound on the largest difference of a leaf (parameter or momentum) between
# two states of one step that sum the step's gradients in different splits,
# relative to that leaf's update in the step: the 2-rank DP step against one
# process's per-image backward summed and halved, and the TP step (fc6 split
# over 2 ranks) against the plain step.  Their sums differ by rounding, which
# the bf16 layers round up to whole ulps (2^-8 of a value) and the layers
# below compound; a fault (a lost image, a doubled update) moves a leaf by
# O(1).  Two computations of the same step (a resumed run, train_net --dp at
# world 1, remat against no remat, phase 4n) are held bit for bit instead:
# train steps are run-independent on the card (kernel A′ sums in an order
# fixed by its inputs; cuDNN is held to deterministic algorithms).
RESUME_STATE_BOUND = 1e-1


def state_spread(a_dir, b_dir, prev_dir=None, lr=None) -> dict:
    """Leaf by leaf, two ``train_state.npz`` of one step (step directories):
    max |a − b| over the max of the leaf's update in the step — |w − w_prev|
    for a parameter where ``prev_dir`` holds the state before the step,
    else lr·|t| (w − w_prev = −lr·t with t the step's momentum trace); the
    trace t itself for a momentum.  A leaf without an update must be equal,
    and so must the counters."""
    def load(d):
        return np.load(os.path.join(d, "train_state.npz"))

    a, b = load(a_dir), load(b_dir)
    prev = load(prev_dir) if prev_dir else None
    out = {}
    for k in a.files:
        if k.startswith("__meta__"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{k} differs between {a_dir} and {b_dir}")
            continue
        if k.startswith("__opt__"):
            update = np.abs(a[k]).max()
        elif prev is not None:
            update = np.abs(a[k] - prev[k]).max()
        else:
            update = lr * np.abs(a["__opt__/trace/" + k[len("params/"):]]).max()
        diff = np.abs(a[k] - b[k]).max()
        if update == 0.0:
            if diff != 0.0:
                raise AssertionError(f"{k} has no update in the step but differs "
                                     f"between {a_dir} and {b_dir}")
            continue
        out[k] = float(diff / update)
    return out


def check_equal_states(what, a_dir, b_dir, prev_dir=None, lr=None) -> str:
    """Two ``train_state.npz`` of one step (step directories) leaf by leaf,
    bit for bit; on a difference raises with ``state_spread``'s largest
    leaves.  Returns a summary."""
    a = np.load(os.path.join(a_dir, "train_state.npz"))
    b = np.load(os.path.join(b_dir, "train_state.npz"))
    differ = [k for k in a.files if k not in b.files or not np.array_equal(a[k], b[k])]
    if differ:
        spread = state_spread(a_dir, b_dir, prev_dir, lr)
        top = sorted(spread, key=spread.get, reverse=True)[:3]
        raise AssertionError(f"{what}: {len(differ)} of {len(a.files)} leaves differ ("
                             + ", ".join(f"{k}: {spread[k]:.2e} of its update" for k in top)
                             + ")")
    summary = f"all {len(a.files)} leaves (parameters, momenta, counters) bit for bit"
    log(f"{what}: {summary}")
    return summary


def check_spread(what, spread) -> str:
    """The summary of a ``state_spread`` (its 3 largest leaves), logged;
    raises beyond ``RESUME_STATE_BOUND``."""
    top = sorted(spread, key=spread.get, reverse=True)[:3]
    summary = (f"max|diff| / max|update| over {len(spread)} leaves: "
               + ", ".join(f"{spread[k]:.2e} ({k})" for k in top)
               + f"; bound {RESUME_STATE_BOUND:.0e}")
    log(f"{what}: {summary}")
    if spread[top[0]] > RESUME_STATE_BOUND:
        raise AssertionError(f"{what}: {top[0]} differs by {spread[top[0]]:.2e} of its update "
                             f"(bound {RESUME_STATE_BOUND:.0e})")
    return f"{spread[top[0]]:.2e} of {top[0]}'s update (bound {RESUME_STATE_BOUND:.0e})"


def real_data_paths(device_label, tmp, caffemodel):
    """Phase 4j: the trees written here (8 SBD images at VOC photo sizes,
    4 COCO images of 80 categories), then ``train_net`` and ``test_net``
    over them at full width, each path with its launch counts; the resumed
    training against the uninterrupted one; the ground-truth oracle; and a
    small f32 model's ``test_net`` (and ``--segdb``) over the SBD tree, card
    against CPU.  Returns the counts by path."""
    from mnc_tpu_torch.data.pascal_voc import PascalVOCSeg

    data = os.path.join(tmp, "real_data")
    t0 = time.perf_counter()
    write_sbd_tree(os.path.join(data, "sbd"))
    write_coco_tree(os.path.join(data, "coco"), "synth")
    log(f"real-format trees: {N_VOC_IMAGES} SBD images ({VOC_SIZES}), {N_COCO_IMAGES} COCO "
        f"images of {len(COCO_CATEGORY_IDS)} categories, written in "
        f"{time.perf_counter() - t0:.1f} s (PNG under .jpg names, RLE segmentations)")
    oracle_scores(data, "synth")
    by_path = {}
    where = ["DATA_DIR", data]

    # train_voc: 4 steps, a snapshot after each; a second run resumes from step 2 and takes
    # step 3, a third resumes from the first run's step 3 and takes step 4
    full = os.path.join(tmp, "train_voc")
    base = ["--imdb", "voc_2012_seg_train", "--print-every", "1", "--device", "cuda"]
    out, sec, counts = run_tool("train_net", base + ["--weights", caffemodel, "--iters", "4",
                                                     "--out", full, "--set", *where,
                                                     "TRAIN.SNAPSHOT_ITERS", "1"])
    runs = {}
    for name, start, iters in (("from_2", 2, 3), ("from_3", 3, 4)):  # no --weights: the
        # snapshot restores every parameter
        d = os.path.join(tmp, f"train_voc_{name}")
        ck = f"ckpt_{start:08d}"
        os.makedirs(os.path.join(d, ck))
        os.link(os.path.join(full, ck, "train_state.npz"),
                os.path.join(d, ck, "train_state.npz"))
        o, sc, c = run_tool("train_net", base + ["--iters", str(iters), "--out", d, "--set",
                                                 *where, "TRAIN.SNAPSHOT_ITERS", "1"])
        if f"resumed from iter {start}" not in o:
            raise AssertionError(f"train_voc: the run {name} did not resume from step {start}")
        counts = {k: counts[k] + c[k] for k in counts}
        runs[name] = (d, o, sc)
    by_path["train_voc"] = counts
    a, b, c = _metrics(full), _metrics(runs["from_2"][0]), _metrics(runs["from_3"][0])
    keys = [k for k in a[3] if k not in ("step", "time", "lr")]
    for step in (1, 2, 3, 4):
        if not all(np.isfinite(a[step][k]) for k in keys):
            raise AssertionError(f"train_voc: a loss of step {step} is not finite: {a[step]}")
    d3 = max(abs(a[3][k] - b[3][k]) for k in keys)
    d4 = max(abs(a[4][k] - c[4][k]) for k in keys)
    log(f"train_voc (VGG-16 full width, --weights {os.path.basename(caffemodel)}): "
        + "; ".join(f"step {s}: total {a[s]['total']:.6f}" for s in (1, 2, 3, 4))
        + f"; resumed from 2: step 3 total {b[3]['total']:.6f}; resumed from 3: step 4 total "
        f"{c[4]['total']:.6f}; launches {by_path['train_voc']}")
    summary = check_equal_states(
        "train_voc step 3", os.path.join(full, "ckpt_00000003"),
        os.path.join(runs["from_2"][0], "ckpt_00000003"), os.path.join(full, "ckpt_00000002"))
    log(f"train_voc resume: step 3 max |loss diff| {d3:.1e} (must be 0: the same snapshot); "
        f"step 4 from the uninterrupted run's step-3 snapshot: max |loss diff| {d4:.1e} (must "
        f"be 0: the forward from one state is deterministic); the two step-3 states (each "
        f"computed anew from step 2): {summary}")
    if d3 != 0.0 or d4 != 0.0:
        raise AssertionError("train_voc: the resumed losses differ from the uninterrupted run's")
    log(f"train_voc on {device_label}: uninterrupted run {sec:.1f} s (4 steps, 4 snapshots), "
        f"resumed runs {runs['from_2'][2]:.1f} s and {runs['from_3'][2]:.1f} s (1 step and 1 "
        f"snapshot each), model build and weight import included; train_net's own step "
        f"average: {_done(out)} / {_done(runs['from_2'][1])} / {_done(runs['from_3'][1])}")

    # test_voc and test_voc_segdb on the trained state
    test = ["--imdb", "voc_2012_seg_val", "--ckpt", full, "--device", "cuda"]
    out, sec, by_path["test_voc"] = run_tool("test_net", test + ["--set", *where])
    log(f"test_voc on {device_label}: {N_VOC_IMAGES} images through pipe.detect in {sec:.1f} s "
        f"(model build included); {out.splitlines()[-1]}; launches {by_path['test_voc']}")
    imdb = PascalVOCSeg("val", os.path.join(data, "sbd"), cache_dir=os.path.join(data, "cache"))
    segdb = oracle_segdb(imdb, os.path.join(tmp, "voc_oracle_segdb"))
    out, sec, by_path["test_voc_segdb"] = run_tool(
        "test_net", test + ["--segdb", segdb, "--set", *where])
    log(f"test_voc_segdb on {device_label}: {N_VOC_IMAGES} images, gt instances as segments, in "
        f"{sec:.1f} s; {out.splitlines()[-1]}; launches {by_path['test_voc_segdb']}")

    # train_coco and test_coco: the ResNet-101 COCO configuration, conv5 head
    coco = ["--imdb", "coco_synth", "--cfg", os.path.join(REPO, "experiments", "cfgs",
                                                          "mnc_coco_resnet101.yml"),
            "--device", "cuda"]
    coco_run = os.path.join(tmp, "train_coco")
    out, sec, by_path["train_coco"] = run_tool(
        "train_net", coco + ["--iters", "2", "--print-every", "1", "--out", coco_run,
                             "--set", "NET.ROI_CONV5", "True", *where])
    m = _metrics(coco_run)
    if not all(np.isfinite(v) for r in m.values() for v in r.values()) or "81 classes" not in out:
        raise AssertionError(f"train_coco: {out[-1500:]}")
    log(f"train_coco on {device_label} (ResNet-101 conv5, 81 classes): 2 steps in {sec:.1f} s "
        f"(model build, 1 snapshot included; {_done(out)}); total {m[1]['total']:.4f}, "
        f"{m[2]['total']:.4f}; launches {by_path['train_coco']}")
    out, sec, by_path["test_coco"] = run_tool(
        "test_net", coco + ["--ckpt", coco_run, "--coco-ap", "--set", "NET.ROI_CONV5", "True",
                            *where])
    if "AP^r@[.5:.95] = " not in out:
        raise AssertionError(f"test_coco: no averaged AP line: {out[-800:]}")
    log(f"test_coco on {device_label}: {N_COCO_IMAGES} images in {sec:.1f} s; "
        f"{out.splitlines()[-1]}; launches {by_path['test_coco']}")
    small_real_test_net_agrees(tmp, data, segdb)
    return by_path


def small_real_test_net_agrees(tmp, data, segdb):
    """A small f32 model's ``test_net`` over the SBD tree (real images
    scaled into a 128x160 canvas), plain and ``--segdb``, on the card and on
    the CPU: the same AP tables."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.utils.checkpoint import jax_params_from_state_dict, save_npz

    small = ["NET.FC_DIM", "64", "NET.MASK_FC_DIM", "32", "NET.COMPUTE_DTYPE", "float32",
             "STATIC.CANVAS", "[128, 160]", "TEST.SCALES", "[96]", "TEST.MAX_SIZE", "160",
             "NET.ANCHOR_SCALES", "[2, 4, 8]", "STATIC.TEST_PRE_NMS_TOP_N", "256",
             "STATIC.TEST_POST_NMS_TOP_N", "64", "DATA_DIR", data]
    arch = MNCArch(canvas=(128, 160), anchor_scales=(2, 4, 8), fc_dim=64, mask_fc_dim=32,
                   compute_dtype=torch.float32)
    npz = os.path.join(tmp, "voc_small.npz")
    save_npz(npz, jax_params_from_state_dict(MNC(arch, device="cpu", seed=4).state_dict()),
             {"bbox_pred_normalized": True})
    for extra in ([], ["--segdb", segdb]):
        tables = {}
        for dev in ("cuda", "cpu"):
            out, sec, _ = run_tool("test_net", ["--imdb", "voc_2012_seg_val", "--npz", npz,
                                                "--device", dev, *extra, "--set", *small])
            tables[dev] = _ap_table(out)
            log(f"small f32 test_net {' '.join(extra[:1])} over the SBD tree on {dev}: "
                f"{sec:.1f} s; {out.splitlines()[-1]}")
        if tables["cuda"] != tables["cpu"]:
            raise AssertionError("small real-image test_net: the AP tables of the card and "
                                 "the CPU differ:\n" + tables["cuda"] + "\n---\n"
                                 + tables["cpu"])
    log("small f32 test_net over the SBD tree, plain and --segdb: the AP tables of the card "
        "and the CPU are identical")


# --------------------------------------------------------------------------- #
# phase 4k: parallel training and evaluation (mnc_tpu_torch/parallel)
# --------------------------------------------------------------------------- #

PAR_SEED = 21  # the draws of the 2-rank steps
# the spatial trunks that run kernels: D (bf16, NET.FUSED_BLOCK1) and E and F (int8 VGG-16)
SPATIAL_KERNEL_ARCHS = {"block1": dict(compute_dtype=torch.bfloat16, fused_block1=True),
                        "int8": dict(compute_dtype=torch.bfloat16, int8_inference=True)}


def _par_setup(kind):
    """The full-width VGG-16 of the 2-rank checks (seed 0, ``make_optimizer``
    defaults), 2 synthetic 640x1024 images and their draws (seed
    ``PAR_SEED``): ``dp`` is phase 4b's bf16 5-stage training network, ``tp``
    the same in f32 with 3 stages (no selection after the heads, so the
    sums of the split fc layers move the losses by rounding alone)."""
    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.train.loop import TrainState, draw_step_randoms, train_cfg_from_cfg
    from mnc_tpu_torch.train.optim import make_optimizer

    arch = MNCArch.from_cfg(train=True)
    if kind == "tp":
        arch = dataclasses.replace(arch, compute_dtype=torch.float32, n_stages=3)
    train_cfg = train_cfg_from_cfg(cfg)
    model = MNC(arch, device="cuda", seed=0, train=True)
    batch = _synthetic_batch(arch, [0, 1])
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    draws = draw_step_randoms(gen, arch, train_cfg, 2, batch["gt_boxes"].shape[-2])
    return arch, train_cfg, TrainState.create(model, make_optimizer(model)), batch, draws


def _par_image():
    return np.random.RandomState(PAR_SEED).randint(0, 256, (*CANVAS, 3)).astype(np.uint8)


def parallel_worker(rank, world, init, out_dir) -> int:
    """One of the 2 gloo ranks sharing the card (``--parallel-worker``): the
    DP step (1 image a rank), the TP step ({data: 1, model: 2}: fc6's
    25088x4096 split in two) with its gathered checkpoint, and the spatial
    trunk (2 x 320 rows of a 640x1024 canvas) in f32, through kernel D
    (bf16, ``FUSED_BLOCK1``; block 1 alone too) and under int8 (kernels E
    and F's halves).  Writes its results (times, metrics, launches), rank 0
    the DP step's checkpoint, every rank its feature rows."""
    import torch.distributed as dist

    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.parallel import (data_parallel_train_step, hybrid_parallel_train_step,
                                        init_distributed, make_mesh, shard_batch, shard_image,
                                        shard_train_state, spatial_trunk_features)
    from mnc_tpu_torch.parallel.spatial import _Halo
    from mnc_tpu_torch.parallel.tensor import save_checkpoint as save_sharded
    from mnc_tpu_torch.utils.blob import device_normalize
    from mnc_tpu_torch.utils.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"file://{init}", int(world), int(rank), device="cuda", backend="gloo",
                     timeout_s=300)
    world = dist.get_world_size()
    res = {}

    def timed(name, fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_counts()}
        return out

    mesh = make_mesh(device="cuda", backend="gloo")
    arch, tc, state, batch, draws = _par_setup("dp")
    step = data_parallel_train_step(state.model, state.opt, arch, tc, mesh)
    state, m = timed("dp", lambda: step(state, shard_batch(batch, mesh), draws))
    res["dp"]["metrics"] = {k: float(v) for k, v in m.items()}
    if dist.get_rank() == 0:
        save_checkpoint(os.path.join(out_dir, "dp"), state, step=1)
    del state, step
    torch.cuda.empty_cache()

    tp_mesh = make_mesh({"data": 1, "model": world}, device="cuda", backend="gloo")
    arch, tc, state, batch, draws = _par_setup("tp")
    shard_train_state(state, tp_mesh)
    res["tp_fc6_shard"] = list(state.model.classify_head.fc6.weight.shape)
    step = hybrid_parallel_train_step(state.model, state.opt, arch, tc, tp_mesh)
    state, m = timed("tp", lambda: step(state, batch, draws))
    res["tp"]["metrics"] = {k: float(v) for k, v in m.items()}
    save_sharded(os.path.join(out_dir, "tp"), state, tp_mesh, step=1)
    del state, step
    torch.cuda.empty_cache()

    model = MNC(MNCArch(compute_dtype=torch.float32), device="cuda", seed=0)
    fn = spatial_trunk_features(model, mesh)
    rows = torch.from_numpy(shard_image(_par_image(), mesh)).cuda()
    fn(rows)  # warm-up: cuDNN's algorithm search
    feat = timed("spatial", lambda: fn(rows))
    np.save(os.path.join(out_dir, f"spatial_{dist.get_rank()}.npy"), feat.cpu().numpy())
    del model, fn
    # the spatial trunk through kernel D (bf16) and through kernels E and F (int8)
    for name, kw in SPATIAL_KERNEL_ARCHS.items():
        model = MNC(MNCArch(**kw), device="cuda", seed=0)
        fn = spatial_trunk_features(model, mesh)
        fn(rows)  # warm-up: cuDNN's algorithm search, E's packed weights
        feat = timed(f"spatial_{name}", lambda: fn(rows))
        np.save(os.path.join(out_dir, f"spatial_{name}_{dist.get_rank()}.npy"),
                feat.float().cpu().numpy())
        if name == "block1":  # block 1 alone: kernel D on this rank's slab
            with torch.no_grad():
                x = device_normalize(rows[None]).to(torch.bfloat16).permute(0, 3, 1, 2)
                b1 = _Halo(mesh, "data").block1(model.trunk, x)
            np.save(os.path.join(out_dir, f"spatial_block1_only_{dist.get_rank()}.npy"),
                    b1.permute(0, 2, 3, 1)[0].float().cpu().numpy())
        del model, fn
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _spawn(argv_of_rank, env_of_rank, what, timeout=600):
    procs = [subprocess.Popen(argv_of_rank(r), cwd=REPO, env={**os.environ, **env_of_rank(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {r} exited {p.returncode}:\n{out[-3000:]}")
    return outs


TOOL_RANK = ("import json, sys; from mnc_tpu_torch.kernels import launch_counts; "
             "from mnc_tpu_torch.tools import {tool} as t; rc = t.main(sys.argv[1:]); "
             "print('LAUNCHES ' + json.dumps(launch_counts()), flush=True); sys.exit(rc)")


def run_tool_ranks(tool, argv, tmp, tag):
    """``tools.<tool>`` as 2 gloo ranks sharing the card (``--dp``): (rank 0's
    output, seconds, the ranks' launches summed)."""
    init = os.path.join(tmp, f"pg_{tag}")
    t0 = time.perf_counter()
    outs = _spawn(lambda r: [sys.executable, "-c", TOOL_RANK.format(tool=tool), *argv, "--dp",
                             "--dist-backend", "gloo", "--dist-init", f"file://{init}"],
                  lambda r: {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)},
                  f"{tool} {tag}")
    seconds = time.perf_counter() - t0
    counts = {}
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("LAUNCHES "))
        for k, v in json.loads(line[len("LAUNCHES "):]).items():
            counts[k] = counts.get(k, 0) + v
    return outs[0], seconds, counts


def _dets(cache):
    import pickle

    with open(cache, "rb") as f:
        dets = pickle.load(f)
    return [(d["image_id"], int(d["class_id"]), float(d["score"]), np.packbits(d["mask"]))
            for d in dets]


def _same_dets(a, b) -> bool:
    return len(a) == len(b) and all(x[:3] == y[:3] and np.array_equal(x[3], y[3])
                                    for x, y in zip(a, b))


def dp_step_overhead(label):
    """The DP step at world 1 (NCCL) against the plain step on one model,
    interleaved after a warm-up: the gradient all-reduce's cost on one card,
    and the bytes it reduces."""
    import torch.distributed as dist

    from mnc_tpu_torch.parallel import data_parallel_train_step, make_mesh
    from mnc_tpu_torch.parallel.mesh import reduce_gradients
    from mnc_tpu_torch.train.loop import make_train_step, mnc_loss

    arch, tc, state, batch, draws = _par_setup("dp")
    mesh = make_mesh(device="cuda")
    steps = {"plain": make_train_step(state.model, state.opt, arch, tc),
             "dp": data_parallel_train_step(state.model, state.opt, arch, tc, mesh)}
    times = {k: [] for k in steps}
    for i in range(4):
        for k in (("plain", "dp") if i % 2 else ("dp", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[k](state, batch, draws)
            torch.cuda.synchronize()
            if i:  # the first pair warms up
                times[k].append((time.perf_counter() - t0) * 1e3)
    # the reduction alone, on one backward's gradients (averaged over 1 rank: unchanged)
    mnc_loss(state.model, batch, draws, arch, state.model.anchors, tc)[0].backward()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    n_bytes = sum(g.numel() * g.element_size() for g in grads)  # what the DP step reduces
    layout = {}
    reduce_ms = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(state.model, mesh.get_group("data"), 1, layout)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    dist.destroy_process_group()
    med = {k: float(np.median(v)) for k, v in times.items()}
    med["reduce"] = float(np.median(reduce_ms[1:]))
    log(f"DP step at world 1 (NCCL) on {label}: median {med['dp']:.1f} ms against the plain "
        f"step's {med['plain']:.1f} ms over {len(times['dp'])} interleaved pairs (2 images, "
        f"full-width VGG-16 bf16; each step trains the model, so the proposals and the host's "
        f"work change from step to step); dp {', '.join(f'{t:.1f}' for t in times['dp'])}; "
        f"plain {', '.join(f'{t:.1f}' for t in times['plain'])}; the gradient reduction alone "
        f"(bucketing, NCCL all-reduce over 1 rank, copy back): median {med['reduce']:.3f} ms of "
        f"{', '.join(f'{t:.3f}' for t in reduce_ms[1:])}, for {n_bytes} bytes of gradients "
        f"({len(grads)} parameters, f32) a step")
    del state, steps
    torch.cuda.empty_cache()
    return med, n_bytes


def spatial_kernel_paths(wdir, res, by_path) -> str:
    """The 2-rank spatial trunks through the kernels against the unsharded
    trunk on the card: under int8 (E and F's halves) the gathered features
    bit for bit; through D (bf16) block 1's gathered rows bit for bit D on
    the whole canvas, and the features, whose later layers are cuDNN
    convolutions of other shapes (320 + 2 rows, no H padding), within 1e-2
    of the map's max.  Adds the paths ``spatial_block1`` / ``spatial_int8``
    (launches summed over the ranks) to ``by_path``; returns a report."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.utils.blob import device_normalize

    parts = []
    img = torch.from_numpy(_par_image()).cuda()[None]
    for name, kw in SPATIAL_KERNEL_ARCHS.items():
        path = f"spatial_{name}"
        by_path[path] = {k: sum(r[path]["launches"][k] for r in res)
                         for k in res[0][path]["launches"]}
        model = MNC(MNCArch(**kw), device="cuda", seed=0)
        with torch.no_grad():
            whole = model.features(img)[0].float().cpu().numpy()
            if name == "block1":
                x = device_normalize(img).to(torch.bfloat16).permute(0, 3, 1, 2)
                whole_b1 = model.trunk._block(0, x).permute(0, 2, 3, 1)[0].float().cpu().numpy()
        del model
        torch.cuda.empty_cache()
        got = np.concatenate([np.load(os.path.join(wdir, f"{path}_{r}.npy")) for r in range(2)])
        if got.shape != whole.shape:
            raise AssertionError(f"2-rank {path}: {got.shape} against {whole.shape}")
        d = float(np.abs(got - whole).max() / np.abs(whole).max())
        same = float((got == whole).mean())
        ms = " / ".join(f"{r[path]['ms']:.1f}" for r in res)
        if name == "int8":
            c = by_path[path]
            if d != 0.0 or c["quant_act_cuda"] or not (c["act_scale_cuda"] and
                                                        c["quant_with_scale_cuda"]
                                                        and c["gemm_s8_cuda"]):
                raise AssertionError(f"2-rank {path}: max diff {d:.1e} of the max from the "
                                     f"unsharded int8 trunk (must be 0), launches {c}")
            parts.append(f"spatial int8 VGG-16 (bf16, E and F's halves) {ms} ms, bit for bit "
                         f"the unsharded int8 trunk")
            continue
        b1 = np.concatenate([np.load(os.path.join(wdir, f"spatial_block1_only_{r}.npy"))
                             for r in range(2)])
        d1 = float(np.abs(b1 - whole_b1).max())
        if b1.shape != whole_b1.shape or d1 != 0.0 or d > 1e-2:
            raise AssertionError(f"2-rank {path}: block 1 max |diff| {d1:.3e} from D on the "
                                 f"whole canvas (must be 0), features {d:.1e} of the max "
                                 f"(tolerance 1e-2)")
        parts.append(f"spatial D trunk (bf16, slabs {tuple(SPATIAL_SLABS['edge'])}) {ms} ms, "
                     f"block 1 bit for bit D on the whole canvas, features max diff {d:.1e} "
                     f"of the map's max ({same:.6f} of the elements equal)")
    return "; ".join(parts)


def parallel_paths(device_label, tmp):
    """Phase 4k: ``train_net --dp`` and ``test_net --dp`` at world 1 through
    NCCL against the plain tools; the DP step's cost at world 1; then 2 gloo
    ranks sharing the card: the DP step, the TP step and the spatial trunk
    against one process, and ``train_net --dp`` / ``test_net --dp``.  Returns
    the counts by path."""
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.parallel.mesh import slice_draws
    from mnc_tpu_torch.train.loop import deterministic_cudnn, make_train_step, mnc_loss
    from mnc_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "real_data")
    if not os.path.isdir(os.path.join(data, "sbd")):
        write_sbd_tree(os.path.join(data, "sbd"))
    where = ["--set", "DATA_DIR", data, "TRAIN.SNAPSHOT_ITERS", "1"]
    by_path = {}

    # train_net --dp at world 1 (NCCL) against train_net: step 1 from the same init, step 2
    # from the DP run's step-1 snapshot; losses and states bit for bit (the all-reduce of
    # one rank sums one term, and the mean divides by 1)
    base = ["--imdb", "voc_2012_seg_train", "--ims-per-batch", "2", "--print-every", "1",
            "--device", "cuda"]
    dp_dir = os.path.join(tmp, "train_dp")
    out, sec, by_path["train_dp"] = run_tool("train_net", base + ["--iters", "2", "--dp",
                                                                  "--out", dp_dir, *where])
    if "data parallel over 1 devices, batch 2" not in out:
        raise AssertionError(f"train_net --dp: no banner:\n{out[-1500:]}")
    plain1, plain2 = os.path.join(tmp, "train_plain_1"), os.path.join(tmp, "train_plain_2")
    run_tool("train_net", base + ["--iters", "1", "--out", plain1, *where])
    os.makedirs(os.path.join(plain2, "ckpt_00000001"))
    os.link(os.path.join(dp_dir, "ckpt_00000001", "train_state.npz"),
            os.path.join(plain2, "ckpt_00000001", "train_state.npz"))
    run_tool("train_net", base + ["--iters", "2", "--out", plain2, *where])
    dp, p1, p2 = _metrics(dp_dir), _metrics(plain1), _metrics(plain2)
    keys = [k for k in dp[1] if k not in ("step", "time", "lr")]
    d1 = max(abs(dp[1][k] - p1[1][k]) for k in keys)
    d2 = max(abs(dp[2][k] - p2[2][k]) for k in keys)
    s1 = check_equal_states("train_net --dp step 1", os.path.join(dp_dir, "ckpt_00000001"),
                            os.path.join(plain1, "ckpt_00000001"), lr=0.001)
    s2 = check_equal_states("train_net --dp step 2", os.path.join(dp_dir, "ckpt_00000002"),
                            os.path.join(plain2, "ckpt_00000002"),
                            os.path.join(dp_dir, "ckpt_00000001"))
    log(f"train_net --dp (world 1, NCCL, full-width VGG-16, SBD tree, 2 images a step) on "
        f"{device_label}: {sec:.1f} s for 2 steps (model build and snapshots included; "
        f"{_done(out)}); totals " + ", ".join(f"{dp[s]['total']:.6f}" for s in (1, 2))
        + f"; against train_net: step 1 max |loss diff| {d1:.1e}, step 2 (from the DP run's "
        f"step-1 state) {d2:.1e} (both must be 0); step-1 states: {s1}; step-2 states: {s2}; "
        f"launches {by_path['train_dp']}")
    if d1 != 0.0 or d2 != 0.0:
        raise AssertionError("train_net --dp: the losses differ from train_net's")
    med, grad_bytes = dp_step_overhead(device_label)

    # test_net --dp --eval-batch 4 at world 1 against --eval-batch 1 (the same one-image
    # runner: equal) and --eval-batch 4 (apply_batch over 4 canvases)
    caches = {}
    for tag, extra in (("dp4", ["--dp", "--eval-batch", "4"]), ("b1", ["--eval-batch", "1"]),
                       ("b4", ["--eval-batch", "4"])):
        caches[tag] = os.path.join(tmp, f"test_{tag}.pkl")
        out, sec, counts = run_tool("test_net", ["--imdb", "synthetic_8", "--device", "cuda",
                                                 "--cache", caches[tag], *extra])
        if tag == "dp4":
            by_path["test_dp"] = counts
            if "--dp: eval batches of 4 sharded over 1 devices" not in out:
                raise AssertionError(f"test_net --dp: no banner:\n{out[-1500:]}")
        log(f"test_net {' '.join(extra)} on synthetic_8 (VGG-16, fc 4096, seeded init) on "
            f"{device_label}: {sec:.1f} s; {out.splitlines()[-1]}; launches {counts}")
    # under TEST.INT8 each rank's image gets its own activation scales: kernels E and F
    for tag, extra in (("dp4_int8", ["--dp", "--eval-batch", "4"]),
                       ("b1_int8", ["--eval-batch", "1"])):
        caches[tag] = os.path.join(tmp, f"test_{tag}.pkl")
        out, sec, counts = run_tool("test_net", ["--imdb", "synthetic_8", "--device", "cuda",
                                                 "--cache", caches[tag], *extra, "--set",
                                                 "TEST.INT8", "True"])
        if tag == "dp4_int8":
            by_path["test_dp_int8"] = counts
        log(f"test_net {' '.join(extra)} --set TEST.INT8 True on synthetic_8 on "
            f"{device_label}: {sec:.1f} s; {out.splitlines()[-1]}; launches {counts}")
    dets = {k: _dets(v) for k, v in caches.items()}
    for a, b in (("dp4", "b1"), ("dp4_int8", "b1_int8")):
        if not _same_dets(dets[a], dets[b]):
            raise AssertionError(f"test_net --dp: the detections of {a} differ from the "
                                 f"one-image runner's ({b})")
    n_diff = sum(1 for x, y in zip(dets["dp4"], dets["b4"]) if x[:3] != y[:3])
    log(f"test_net --dp --eval-batch 4: {len(dets['dp4'])} detections ({len(dets['dp4_int8'])} "
        f"under TEST.INT8), equal to --eval-batch 1's (the same one-image runner); against --eval-batch 4 without --dp (apply_batch over 4 "
        f"canvases): {len(dets['b4'])} detections, {n_diff} differing in image, class or score")

    # 2 gloo ranks sharing the card: the DP step, the TP step, the spatial trunk
    wdir = os.path.join(tmp, "parallel_worker")
    os.makedirs(wdir)
    t0 = time.perf_counter()
    _spawn(lambda r: [sys.executable, os.path.abspath(__file__), "--parallel-worker", str(r),
                      "2", os.path.join(tmp, "pg_worker"), wdir], lambda r: {}, "2-rank worker")
    sec = time.perf_counter() - t0
    res = [json.load(open(os.path.join(wdir, f"rank{r}.json"))) for r in range(2)]

    # the DP step against one process: each image's loss and backward, the gradients summed
    # and halved (what the all-reduce of 2 ranks computes), then the solver
    arch, tc, state, batch, draws = _par_setup("dp")
    per = []
    with deterministic_cudnn():
        for i in range(2):
            total, m = mnc_loss(state.model, {k: v[i:i + 1] for k, v in batch.items()},
                                slice_draws(draws, i, 1), arch, state.model.anchors, tc)
            total.backward()
            per.append(m)
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.div_(2)
        state.opt.step()
    state.step += 1
    want = {k: float((per[0][k].detach() + per[1][k].detach()) / 2) for k in per[0]}
    save_checkpoint(os.path.join(tmp, "dp_one"), state, step=1)
    del state
    torch.cuda.empty_cache()
    dd = max(abs(res[r]["dp"]["metrics"][k] - want[k]) for r in range(2) for k in want)
    sdp = check_spread("2-rank DP step", state_spread(os.path.join(wdir, "dp", "ckpt_00000001"),
                                                      os.path.join(tmp, "dp_one",
                                                                   "ckpt_00000001"), lr=0.001))
    if dd != 0.0:
        raise AssertionError(f"2-rank DP step: the losses differ from one process's by {dd}")

    # the TP step against the plain step on the same 2 images and draws
    arch, tc, state, batch, draws = _par_setup("tp")
    _, m = make_train_step(state.model, state.opt, arch, tc)(state, batch, draws)
    want = {k: float(v) for k, v in m.items()}
    save_checkpoint(os.path.join(tmp, "tp_one"), state, step=1)
    del state
    torch.cuda.empty_cache()
    dt = max(abs(res[r]["tp"]["metrics"][k] - want[k]) / max(abs(want[k]), 1e-6)
             for r in range(2) for k in want)
    stp = check_spread("2-rank TP step", state_spread(os.path.join(wdir, "tp", "ckpt_00000001"),
                                                      os.path.join(tmp, "tp_one",
                                                                   "ckpt_00000001"), lr=0.001))
    if dt > 1e-5 or res[0]["tp_fc6_shard"] != [2048, 25088]:
        raise AssertionError(f"2-rank TP step: losses {dt:.1e} relative from one process's "
                             f"(tolerance 1e-5), fc6 shard {res[0]['tp_fc6_shard']}")

    # the spatial trunk against model.features on the whole canvas (f32, TF32 off)
    model = MNC(MNCArch(compute_dtype=torch.float32), device="cuda", seed=0)
    with torch.no_grad():
        whole = model.features(torch.from_numpy(_par_image()).cuda()[None])[0].cpu().numpy()
    del model
    got = np.concatenate([np.load(os.path.join(wdir, f"spatial_{r}.npy")) for r in range(2)])
    ds = float(np.abs(got - whole).max() / np.abs(whole).max())
    if got.shape != whole.shape or ds > 1e-4:
        raise AssertionError(f"2-rank spatial trunk: {got.shape} against {whole.shape}, "
                             f"max diff {ds:.1e} of the max (tolerance 1e-4)")
    for name in ("dp", "tp", "spatial"):
        by_path[f"{name}_gloo"] = {k: sum(r[name]["launches"][k] for r in res)
                                   for k in res[0][name]["launches"]}
    spatial_kernels = spatial_kernel_paths(wdir, res, by_path)
    log(f"2 gloo ranks sharing {device_label} ({sec:.1f} s for both processes, start-up and "
        f"model builds included; times are not a speed measure: two processes share one card "
        f"and gloo moves CUDA tensors through the host): DP step (1 image a rank, bf16) "
        f"{res[0]['dp']['ms']:.1f} / {res[1]['dp']['ms']:.1f} ms, losses equal to one "
        f"process's (max diff {dd:.1e}), states: {sdp}; TP step ({{data: 1, model: 2}}, fc6 "
        f"shard {res[0]['tp_fc6_shard']}, f32 3-stage) {res[0]['tp']['ms']:.1f} / "
        f"{res[1]['tp']['ms']:.1f} ms, losses {dt:.1e} relative from the plain step's "
        f"(tolerance 1e-5), gathered checkpoint: {stp}; spatial trunk (2 x 320 rows of "
        f"640x1024, f32) {res[0]['spatial']['ms']:.1f} / {res[1]['spatial']['ms']:.1f} ms, "
        f"max diff {ds:.1e} of the map's max (tolerance 1e-4); {spatial_kernels}; launches "
        f"dp {by_path['dp_gloo']}, tp {by_path['tp_gloo']}, spatial_block1 "
        f"{by_path['spatial_block1']}, spatial_int8 {by_path['spatial_int8']}")

    # train_net --dp and test_net --dp as 2 gloo ranks sharing the card
    gdir = os.path.join(tmp, "train_dp_gloo")
    out, sec, by_path["train_dp_gloo"] = run_tool_ranks(
        "train_net", base + ["--iters", "1", "--out", gdir, *where], tmp, "train")
    g = _metrics(gdir)
    if "data parallel over 2 devices, batch 2" not in out or not all(
            np.isfinite(g[1][k]) for k in keys):
        raise AssertionError(f"train_net --dp on 2 gloo ranks:\n{out[-1500:]}")
    log(f"train_net --dp on 2 gloo ranks sharing the card: {sec:.1f} s for 1 step of 1 image "
        f"a rank (start-up and a snapshot included); total {g[1]['total']:.6f} (world 1: "
        f"{dp[1]['total']:.6f}; bf16 convolutions of 1 image and of 2 round apart); launches "
        f"{by_path['train_dp_gloo']}")
    cache = os.path.join(tmp, "test_dp_gloo.pkl")
    out, sec, by_path["test_dp_gloo"] = run_tool_ranks(
        "test_net", ["--imdb", "synthetic_8", "--device", "cuda", "--eval-batch", "4",
                     "--cache", cache], tmp, "test")
    if "--dp: eval batches of 4 sharded over 2 devices" not in out or not _same_dets(
            _dets(cache), dets["dp4"]):
        raise AssertionError(f"test_net --dp on 2 gloo ranks: not the world-1 detections:\n"
                             f"{out[-1500:]}")
    log(f"test_net --dp --eval-batch 4 on 2 gloo ranks sharing the card: {sec:.1f} s; the "
        f"detections equal world 1's; {out.splitlines()[-2]}; launches "
        f"{by_path['test_dp_gloo']}")
    log(f"phase 4k on {device_label}: {time.perf_counter() - t_phase:.1f} s in all; DP step "
        f"at world 1 {med['dp']:.1f} ms against {med['plain']:.1f} ms, its reduction "
        f"{med['reduce']:.3f} ms for {grad_bytes} gradient bytes a step")
    return by_path


# --------------------------------------------------------------------------- #
# phase 4l: the train -> detect -> mAP^r tools and the last ported modules
# --------------------------------------------------------------------------- #

E2E_VGG = ["--full-scale", "--iters", "6", "--batch", "2", "--train-images", "8",
           "--eval-images", "4", "--eval-every", "3", "--int8-eval", "--device", "cuda"]
E2E_REMAT = ["--full-scale", "--trunk", "resnet101", "--roi-conv5", "--iters", "2", "--batch",
             "2", "--train-images", "4", "--eval-images", "2", "--device", "cuda"]
ABLATION = ["--eval-images", "4", "--val-seeds", "99", "7", "--bootstrap", "50", "--coco-ap",
            "--device", "cuda"]
ABLATION_SMOKE = ["--smoke", "--val-seeds", "99", "7", "--bootstrap", "20", "--coco-ap"]
EF = ("gemm_s8_cuda", "quant_act_cuda")


@contextlib.contextmanager
def patched(module, name, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def counting(fn, sink: list, keep=None):
    """``fn`` wrapped: each call appends (its launch counts, its seconds
    between two synchronizes, ``keep(result)``) to ``sink``."""
    from mnc_tpu_torch.kernels import launch_counts

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        after = launch_counts()
        sink.append(({k: after[k] - before[k] for k in after}, time.perf_counter() - t0,
                     keep(out) if keep else None))
        return out

    return wrapper


def _summed(calls) -> dict:
    from mnc_tpu_torch.kernels import launch_counts

    total = dict.fromkeys(launch_counts(), 0)
    for counts, _, _ in calls:
        for k, v in counts.items():
            total[k] += v
    return total


def _final_json(stdout) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def e2e_vgg_path(device_label, tmp):
    """(i) ``e2e_synth_demo --full-scale`` on VGG-16 (640x1024, FC 4096, M 21,
    pre-/post-NMS 2048/512, bf16): 6 steps of 2 images, one evaluation at
    step 3, the final one, and the int8 evaluation of the same weights.
    Every step's losses finite, every kernel moved, one EVAL line and the
    final JSON line; kernels E and F launched in the int8 evaluation only.
    Returns the launch counts by path and the trained npz."""
    from mnc_tpu_torch.tools import e2e_synth_demo as E
    from mnc_tpu_torch.train import loop

    steps, evals, int8s, held = [], [], [], {}
    build = loop.build_train_step

    def build_counted(model, opt, arch, train_cfg):
        held["model"] = model
        held["before"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        return counting(build(model, opt, arch, train_cfg), steps,
                        lambda out: {k: float(v) for k, v in out[1].items()})

    out_dir = os.path.join(tmp, "e2e_vgg16")
    with patched(loop, "build_train_step", build_counted), \
            patched(E, "evaluate", counting(E.evaluate, evals)), \
            patched(E, "int8_evaluate", counting(E.int8_evaluate, int8s)):
        stdout, sec, total = run_tool("e2e_synth_demo", E2E_VGG + ["--out", out_dir])
    final = _final_json(stdout)
    if set(final) != {"map_r_050", "map_r_070", "iters", "batch", "int8_map_r_050",
                      "int8_map_r_070"} or (final["iters"], final["batch"]) != (6, 2):
        raise AssertionError(f"e2e_synth_demo: final line {final}")
    if stdout.count("\nEVAL ") != 1 or len(steps) != 6 or len(evals) != 3 or len(int8s) != 1:
        raise AssertionError(f"e2e_synth_demo: {stdout.count('EVAL ')} EVAL lines, "
                             f"{len(steps)} steps, {len(evals)} + {len(int8s)} evaluations")
    for i, (_, _, m) in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"e2e_synth_demo step {i + 1}: a loss is not finite: {m}")
    params = dict(held["model"].named_parameters())
    still = sorted(n for n, p in params.items() if torch.equal(p, held["before"][n]))
    if any(not n.endswith("bias") for n in still):
        raise AssertionError(f"e2e_synth_demo: kernels unchanged after 6 steps: {still}")
    del held
    int8_counts = _summed(int8s)  # its evaluate call is among ``evals`` too
    by_path = {"e2e_train": _summed(steps),
               "e2e_eval": {k: v - int8_counts[k] for k, v in _summed(evals).items()},
               "e2e_int8_eval": int8_counts}
    for path in ("e2e_train", "e2e_eval"):
        if any(by_path[path][k] for k in EF):
            raise AssertionError(f"e2e_synth_demo: E or F launched on {path}: {by_path[path]}")
    if not all(by_path["e2e_int8_eval"][k] for k in EF):
        raise AssertionError(f"e2e_synth_demo: the int8 evaluation launched no E or F: "
                             f"{by_path['e2e_int8_eval']}")
    step_ms = [t * 1e3 for _, t, _ in steps]
    log(f"e2e_synth_demo --full-scale VGG-16 on {device_label}: {sec:.1f} s in all; step "
        f"walls (2 images) " + ", ".join(f"{x:.1f}" for x in step_ms) + " ms; evaluations of "
        f"4 images " + ", ".join(f"{t:.2f}" for _, t, _ in evals[:2]) + f" s; int8 evaluation "
        f"{int8s[0][1]:.2f} s (its model build included); losses step 1 / 6: total "
        f"{steps[0][2]['total']:.4f} / {steps[-1][2]['total']:.4f}; {len(still)} biases "
        f"unchanged (no gradient, no decay); final {final}; launches {by_path}")
    return by_path, os.path.join(out_dir, "e2e_params.npz")


def e2e_remat_path(device_label, tmp):
    """(ii) ``e2e_synth_demo --full-scale --trunk resnet101 --roi-conv5``
    (so ``remat_trunk`` is on), 2 steps; then one step of the same model
    with and without remat from the same init and draws: step 1's losses
    bit for bit, the states bit for bit (the same step; the trunk's forward
    is recomputed in the backward by the same deterministic algorithms),
    the remat step's peak memory lower."""
    from mnc_tpu_torch.data.synth_imdb import SyntheticIMDB
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.tools import e2e_synth_demo as E
    from mnc_tpu_torch.train.loop import TrainState, build_train_step, draw_step_randoms
    from mnc_tpu_torch.train.optim import make_optimizer

    stdout, sec, counts = run_tool("e2e_synth_demo",
                                   E2E_REMAT + ["--out", os.path.join(tmp, "e2e_r101")])
    final = _final_json(stdout)
    first = next(ln for ln in stdout.splitlines() if ln.startswith("iter 1: "))
    if final["iters"] != 2 or "nan" in first or "inf" in first:
        raise AssertionError(f"e2e_synth_demo ResNet-101: {first}; {final}")
    log(f"e2e_synth_demo --full-scale --trunk resnet101 --roi-conv5 on {device_label}: "
        f"{sec:.1f} s in all; {first}; final {final}; launches {counts}")

    args = E.parse_args(E2E_REMAT)
    arch, train_cfg, gt_mask_size, max_gt = E.build_arch(args)
    if not arch.remat_trunk:
        raise AssertionError("e2e_synth_demo: remat_trunk is off for ResNet-101")
    data = SyntheticIMDB(canvas_hw=arch.canvas, num_classes=arch.num_classes, max_gt=max_gt,
                         gt_mask_size=gt_mask_size, num_images=2, seed=1)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.gen.batch([0, 1]).items()}
    draws = draw_step_randoms(torch.Generator(device="cuda").manual_seed(0), arch, train_cfg,
                              2, max_gt)
    res, init = {}, None
    for remat in (True, False):
        a = dataclasses.replace(arch, remat_trunk=remat)
        model = MNC(a, device="cuda", seed=args.seed, train=True)
        if init is None:
            init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = make_optimizer(model, base_lr=args.lr, stepsize=1, clip_gradients=10.0)
        state = TrainState.create(model, opt)
        step = build_train_step(model, opt, a, train_cfg)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        after = {n: p.detach().clone() for n, p in model.named_parameters()}
        walls = []
        for _ in range(2):  # warm steps, timed (the first step grows the allocator)
            t0 = time.perf_counter()
            step(state, batch, draws)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        res[remat] = ({k: float(v) for k, v in metrics.items()}, after, walls, peak)
        del model, opt, state, step, metrics, after
        torch.cuda.empty_cache()
    (lr_, sr, msr, pr), (lp, sp, msp, pp) = res[True], res[False]
    if lr_ != lp:
        raise AssertionError(f"remat step 1: losses differ from the plain step's: {lr_} vs {lp}")
    differ = {}
    for n, p0 in init.items():
        if not torch.equal(sr[n], sp[n]):
            upd = (sp[n] - p0).abs().max().item()
            differ[n] = (sr[n] - sp[n]).abs().max().item() / max(upd, 1e-30)
    if differ or not pr < pp:
        top = sorted(differ, key=differ.get, reverse=True)[:3]
        raise AssertionError(f"remat step: {len(differ)} parameters differ from the plain "
                             f"step's ({', '.join(f'{n}: {differ[n]:.2e} of its update' for n in top)}); "
                             f"peak {pr:.2f} GiB against {pp:.2f} GiB")
    log(f"remat_trunk on {device_label} (ResNet-101 conv5 head, 2 images, 640x1024): step 1 "
        f"losses equal bit for bit to the plain step's (total {lr_['total']:.6f}); all "
        f"{len(init)} parameters bit for bit; peak memory "
        f"above the resident {pr:.2f} GiB with remat against {pp:.2f} GiB without; warm step "
        f"walls {', '.join(f'{x:.1f}' for x in msr)} against "
        f"{', '.join(f'{x:.1f}' for x in msp)} ms")
    return {"e2e_remat": counts}


def ablation_paths(device_label, tmp, npz):
    """(iii) ``ablation_study`` at full scale on (i)'s weights: the 8 variant
    records (4 images over 2 seeds, 50 bootstrap resamples, COCO AP), then a
    second run of ``--only 3stage`` whose record carries the paired deltas
    against ``5stage``; ``5stage_int8`` launches E and F.  (vii) The
    ``--smoke`` configuration on the card and on the CPU: the same records
    but ``ms_per_img``."""
    from mnc_tpu_torch.pipeline.inference import PostCfg
    from mnc_tpu_torch.tools import ablation_study as A

    runs = []
    append = os.path.join(tmp, "ablation.jsonl")
    with patched(A, "run_variant", counting(A.run_variant, runs)):
        stdout, sec, _ = run_tool("ablation_study",
                                  ["--params", npz, *ABLATION, "--append", append])
    recs = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    labels = [r["config"] for r in recs]
    if labels != list(A.variants(A.base_arch(A.parse_args([])), PostCfg())) or len(runs) != 8:
        raise AssertionError(f"ablation_study: records {labels}")
    by_path = {f"ablation_{r['config']}": c for r, (c, _, _) in zip(recs, runs)}
    for label, c in by_path.items():
        if bool(c["gemm_s8_cuda"] and c["quant_act_cuda"]) != (label == "ablation_5stage_int8"):
            raise AssertionError(f"ablation_study: E/F launches on {label}: {c}")
    for r in recs:
        log(f"ablation {r['config']:<18} on {device_label}: mAP^r .5/.7 {r['map_r_050']:.4f}/"
            f"{r['map_r_070']:.4f} avg {r['map_r_avg']:.4f}; CI .5 {r['ci_050']}; "
            f"{r['ms_per_img']:.1f} ms per image; launches {by_path['ablation_' + r['config']]}")
    stdout2, sec2, _ = run_tool("ablation_study", ["--params", npz, *ABLATION, "--append",
                                                   append, "--only", "3stage"])
    (only,) = [json.loads(ln) for ln in stdout2.splitlines() if ln.startswith("{")]
    if "delta_050_vs_5stage" not in only or "delta_070_vs_5stage" not in only:
        raise AssertionError(f"ablation_study --only 3stage: no paired deltas: {only}")
    log(f"ablation_study on {device_label}: 8 variants {sec:.1f} s, --only 3stage {sec2:.1f} s; "
        f"paired deltas vs 5stage {only['delta_050_vs_5stage']} / "
        f"{only['delta_070_vs_5stage']}")

    smoke = {}
    for dev in ("cuda", "cpu"):
        out, s, _ = run_tool("ablation_study", [*ABLATION_SMOKE, "--device", dev])
        smoke[dev] = ([{k: v for k, v in json.loads(ln).items() if k != "ms_per_img"}
                       for ln in out.splitlines() if ln.startswith("{")], s)
    if smoke["cuda"][0] != smoke["cpu"][0] or len(smoke["cpu"][0]) != 8:
        raise AssertionError(f"ablation_study --smoke: card and CPU records differ:\n"
                             f"{smoke['cuda'][0]}\n{smoke['cpu'][0]}")
    log(f"ablation_study --smoke (f32) on {device_label}: the 8 records equal to the CPU's "
        f"but ms_per_img ({smoke['cuda'][1]:.1f} / {smoke['cpu'][1]:.1f} s)")
    return by_path


def ported_ops_agree(device_label, vgg):
    """(iv) ``TEST.VOTE_IMPL gather`` against ``einsum`` on phase 4a's first
    request; (v) ``roi_pool`` on a VGG conv5 map and the whole-class voting
    ops, card against CPU; (vi) ``rle_encode`` of one full-resolution mask,
    the compiled helper against numpy."""
    from mnc_tpu_torch import native
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.ops import mask_voting as mv
    from mnc_tpu_torch.ops.roi_warp import roi_pool
    from mnc_tpu_torch.pipeline.inference import PostCfg, postprocess_detections, vote_candidates

    model = MNC(vgg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)  # serve_path's first request
    req = torch.randint(0, 256, (4, *vgg.canvas, 3), generator=g, device="cuda",
                        dtype=torch.uint8)
    infos = torch.tensor([[float(vgg.canvas[0]), float(vgg.canvas[1]), 1.0]] * 4, device="cuda")
    net = model.apply_batch(req, infos)
    feat = model.features(req)
    del model
    outs, ms = {}, {}
    for impl in ("einsum", "gather"):
        post = PostCfg.from_cfg(dets_per_class=16, vote_impl=impl)

        def run(post=post):
            with torch.inference_mode():
                return postprocess_detections(*vote_candidates(net, post, 5, axis=1), post,
                                              vgg.canvas)

        outs[impl] = run()
        ms[impl] = cuda_ms(run, iters=10, warmup=2)
    a, b = outs["einsum"], outs["gather"]
    for key in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"vote_impl gather: {key} differs from einsum's")
    merr = (a["masks"] - b["masks"]).abs().max().item()
    mism = (a["canvas_masks"] != b["canvas_masks"]).float().mean().item()
    if merr > 1e-5 or mism > 1e-4:
        raise AssertionError(f"vote_impl gather: masks {merr:.2e}, canvas pixels {mism:.2e}")
    log(f"vote_impl on {device_label}, phase 4a's request (4 canvases, {int(a['valid'].sum())} "
        f"detections): gather's detections equal einsum's, merged masks within {merr:.2e} "
        f"(tolerance 1e-5), canvas pixels differing {mism:.2e}; postprocess {ms['einsum']:.3f} "
        f"ms (einsum) against {ms['gather']:.3f} ms (gather)")

    gp = torch.Generator(device="cuda").manual_seed(4)
    rois = torch.stack([random_boxes(gp, 76, *vgg.canvas) for _ in range(4)])
    got = roi_pool(feat, rois, (7, 7), 1 / 16)
    want = roi_pool(feat.cpu(), rois.cpu(), (7, 7), 1 / 16)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("roi_pool: the card's result differs from the CPU's")
    pool_ms = cuda_ms(lambda: roi_pool(feat, rois, (7, 7), 1 / 16), iters=5, warmup=1)
    # one class's candidates of the request's first canvas
    cand, scores = net["rois"][0], net["cls_prob"][0, :, 1]
    masks, valid = torch.sigmoid(net["mask_logits"][0].float()), net["roi_valid"][0]
    kept = cand[torch.sort(scores, descending=True, stable=True).indices[:16]]
    args = (kept, cand, scores, masks, valid)
    mg, mc = mv.mask_voting(*args), mv.mask_voting(*(t.cpu() for t in args))
    bg = mv.box_voting(kept, cand, scores, valid)
    bc = mv.box_voting(*(t.cpu() for t in (kept, cand, scores, valid)))
    verr, berr = (mg.cpu() - mc).abs().max().item(), (bg.cpu() - bc).abs().max().item()
    if verr > 1e-4 or berr > 1e-3:  # f32 sums of up to 304 terms in another order
        raise AssertionError(f"mask_voting / box_voting: card against CPU {verr:.2e} / {berr:.2e}")
    vote_ms = cuda_ms(lambda: mv.mask_voting(*args), iters=10, warmup=2)
    log(f"roi_pool on {device_label}: {tuple(feat.shape)} {feat.dtype} map, {rois.shape[1]} RoIs "
        f"an image, 7x7: equal to the CPU's bit for bit; {pool_ms:.3f} ms on the card. "
        f"mask_voting / box_voting on one class's {cand.shape[0]} candidates, 16 kept: card "
        f"against CPU {verr:.2e} / {berr:.2e} px (tolerances 1e-4 / 1e-3); mask_voting "
        f"{vote_ms:.3f} ms on the card")

    yy, xx = np.mgrid[:640, :1024]
    mask = (((yy - 300) / 180.0) ** 2 + ((xx - 520) / 310.0) ** 2 <= 1.0).astype(np.uint8)
    lib, plain = native.rle_encode(mask), native.rle_encode_plain(mask)
    if not np.array_equal(lib["counts"], plain["counts"]):
        raise AssertionError("rle_encode: the compiled helper differs from numpy")
    t = {}
    for name, fn in (("lib", native.rle_encode), ("numpy", native.rle_encode_plain)):
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn(mask)
            walls.append(time.perf_counter() - t0)
        t[name] = float(np.median(walls)) * 1e3
    log(f"rle_encode of one 640x1024 mask ({len(lib['counts'])} runs) on the host of "
        f"{device_label}: compiled {t['lib']:.3f} ms against numpy {t['numpy']:.3f} ms "
        f"(medians of 20), equal counts")


def tools_paths(device_label, tmp, vgg) -> dict:
    """Phases 4l and 4m (on 4l's trained npz); returns the launch counts by
    path."""
    t_phase = time.perf_counter()
    by_path, npz = e2e_vgg_path(device_label, tmp)
    torch.cuda.empty_cache()
    by_path.update(e2e_remat_path(device_label, tmp))
    torch.cuda.empty_cache()
    by_path.update(ablation_paths(device_label, tmp, npz))
    torch.cuda.empty_cache()
    ported_ops_agree(device_label, vgg)
    torch.cuda.empty_cache()
    log(f"phase 4l on {device_label}: {time.perf_counter() - t_phase:.1f} s in all")
    by_path.update(study_paths(device_label, tmp, npz))
    torch.cuda.empty_cache()
    return by_path


# --------------------------------------------------------------------------- #
# phase 4m: the study tools (reference_parity, workingset, crowd, mask fidelity)
# --------------------------------------------------------------------------- #

WORKINGSET = ["--eval-images", "4", "--pre-nms", "512", "6000", "--post-nms", "304",
              "--device", "cuda"]
CROWD = ["--eval-images", "2", "--only", "16,0", "--device", "cuda"]


def parity_paths(device_label, tmp) -> dict:
    """``reference_parity --dry-run`` and ``--dry-run --fabricate proto``,
    each through its ``test_net`` subprocess (PARITY: PASS, exit 0); then the
    fabricated run's ``test_net`` argv in this process (its own tree and
    caffemodel, made alike): its mAP^r equal to the numbers the tool parsed,
    and its launches the path ``parity_test_net``."""
    from mnc_tpu_torch.tools import reference_parity as R

    runs = {}
    for tag, extra in (("random", []), ("fabricated", ["--fabricate", "proto"])):
        out, sec, _ = run_tool("reference_parity", ["--dry-run", "--device", "cuda", *extra])
        if out.strip().splitlines()[-1] != "PARITY: PASS":
            raise AssertionError(f"reference_parity --dry-run {extra}:\n{out[-2000:]}")
        runs[tag] = (R.parse_map(out), sec)
    root = os.path.join(tmp, "parity", "sbd")
    R.build_mini_sbd(root)
    args = R.parse_args(["--dry-run", "--device", "cuda", "--cache",
                         os.path.join(tmp, "parity", "detections.pkl")])
    args.caffemodel = R.fabricate(os.path.dirname(root), "proto", [])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as in the subprocess
    try:
        out, sec, counts = run_tool("test_net", R.net_argv(args, root, dry=True))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    aps = R.parse_map(out)
    if aps != runs["fabricated"][0]:
        raise AssertionError(f"test_net in process: mAP^r {aps} against the tool's parsed "
                             f"{runs['fabricated'][0]}")
    pts = {k: "/".join(f"{v:.2f}" for v in r[0]) for k, r in runs.items()}
    log(f"reference_parity --dry-run on {device_label}: PARITY: PASS with random weights "
        f"(mAP^r .5/.7 {pts['random']} points, {runs['random'][1]:.1f} s) and with a "
        f"fabricated full-size caffemodel ({pts['fabricated']} points, "
        f"{runs['fabricated'][1]:.1f} s, the subprocess's start-up, import and 4 images); "
        f"its test_net argv in process: the same mAP^r; {sec:.1f} s; launches {counts}")
    return {"parity_test_net": counts}


def study_paths(device_label, tmp, npz) -> dict:
    """Phase 4m on phase 4l's trained full-scale npz: ``reference_parity``
    (:func:`parity_paths`), ``workingset_study`` (4 images, pre-NMS 512 and
    6000, post-NMS 304: recall and mAP^r per point), ``crowd_study`` (2
    images of 20-30 instances, dets_per_class 16 with every candidate
    voting), and ``mask_fidelity_study --trials 50``.  Every record's
    numbers finite; returns the launch counts by path."""
    t_phase = time.perf_counter()
    by_path = parity_paths(device_label, tmp)
    torch.cuda.empty_cache()
    out, sec, by_path["workingset"] = run_tool("workingset_study", ["--params", npz,
                                                                    *WORKINGSET])
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if [r["config"] for r in recs] != ["pre_nms=512,dets_per_class=16",
                                       "pre_nms=6000,dets_per_class=16",
                                       "pre_nms=6000,post_nms=304,dets_per_class=16",
                                       "pre_nms=1024,dets_per_class=100"] or not all(
            np.isfinite(v) for r in recs for k, v in r.items() if k != "config"):
        raise AssertionError(f"workingset_study: records {recs}")
    for r in recs:
        log(f"workingset {r['config']:<44} on {device_label}: recall .5/.7 "
            f"{r['recall@.5']:.4f}/{r['recall@.7']:.4f} mAP^r .5/.7 {r['map_r_050']:.4f}/"
            f"{r['map_r_070']:.4f} {r['ms_per_img']:.1f} ms per image")
    log(f"workingset_study on {device_label}: {sec:.1f} s; launches {by_path['workingset']}")
    torch.cuda.empty_cache()
    out, sec, by_path["crowd"] = run_tool("crowd_study", ["--params", npz, *CROWD])
    (rec,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if rec["config"] != "dets_per_class=16,vote_top_k=all" or rec["n_images"] != 2 or not (
            20 <= rec["instances_per_image"] <= 30):
        raise AssertionError(f"crowd_study: record {rec}")
    log(f"crowd_study on {device_label}: {rec}; {sec:.1f} s; launches {by_path['crowd']}")
    torch.cuda.empty_cache()
    out, sec, counts = run_tool("mask_fidelity_study", ["--trials", "50", "--device", "cuda"])
    rows = [ln for ln in out.splitlines() if ln.split()[1:2] in (["nearest"], ["area"])]
    if len(rows) != 8:
        raise AssertionError(f"mask_fidelity_study: table\n{out}")
    log(f"mask_fidelity_study --trials 50 on {device_label}: {sec:.1f} s; "
        + "; ".join(" ".join(r.split()) for r in rows))
    log(f"phase 4m on {device_label}: {time.perf_counter() - t_phase:.1f} s in all")
    return by_path


def nondeterminism_warnings(fn) -> list:
    """The distinct first lines of the warnings that ``fn()`` gives under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (each op
    that has no deterministic implementation warns), synchronized."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).strip().splitlines()[0][:240] for w in caught})


def _train_snapshot(model, opt, state):
    """Copies of every parameter, momentum trace and counter of a train state."""
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            [t.clone() for t in opt.trace], opt.count, opt.mini_step, state.step)


def _train_restore(model, opt, state, snap):
    params, trace, count, mini_step, step = snap
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
        for t, v in zip(opt.trace, trace):
            t.copy_(v)
    opt.count, opt.mini_step, state.step = count, mini_step, step


def step_twice(name, model, opt, state, step, batch, draws) -> dict:
    """``step`` twice from one state, one batch and one draw (the state
    restored in place between them): every parameter, momentum, counter and
    metric must be bit for bit the same, the counterpart of the JAX
    package's ``test_training_is_deterministic``.  Then once more from the
    same state under ``nondeterminism_warnings``, a diagnostic whose list
    must be empty (its state is not compared: under it torch picks other
    algorithms for some ops).  Returns the leaves compared, the leaves the
    step moved and the diagnostic's warnings."""
    snap = _train_snapshot(model, opt, state)
    runs, walls = [], []
    for _ in range(2):
        _train_restore(model, opt, state, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        runs.append((_train_snapshot(model, opt, state),
                     {k: v.detach().clone() for k, v in metrics.items()}))
    (a, ma), (b, mb) = runs
    differ = [n for n in a[0] if not torch.equal(a[0][n], b[0][n])]
    differ += [f"momentum {opt.names[i]}" for i, (x, y) in enumerate(zip(a[1], b[1]))
               if not torch.equal(x, y)]
    differ += [f"metric {k}" for k in ma if not torch.equal(ma[k], mb[k])]
    if a[2:] != b[2:]:
        differ.append(f"counters {a[2:]} / {b[2:]}")
    moved = sum(not torch.equal(a[0][n], snap[0][n]) for n in a[0])
    spread = {}
    for n in differ[:5]:
        if n in a[0]:
            upd = (a[0][n] - snap[0][n]).abs().max().item()
            spread[n] = (a[0][n] - b[0][n]).abs().max().item() / max(upd, 1e-30)
    del b
    _train_restore(model, opt, state, snap)
    diag = nondeterminism_warnings(lambda: step(state, batch, draws))
    _train_restore(model, opt, state, a)
    log(f"determinism {name}: two steps from one state: {len(a[0])} parameters, "
        f"{len(a[1])} momenta, {len(ma)} metrics, "
        + ("all bit for bit" if not differ else f"{len(differ)} DIFFER: {differ[:8]}; "
           f"max |diff| / max |update| {spread}")
        + f" ({moved} parameters moved; total {float(ma['total']):.6f}; walls "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms); use_deterministic_algorithms "
        f"warn_only: {len(diag)} warnings: {diag}")
    if differ:
        raise AssertionError(f"determinism {name}: two steps from one state differ in "
                             f"{differ[:8]}")
    if diag:
        raise AssertionError(f"determinism {name}: ops without a deterministic "
                             f"implementation: {diag}")
    return {"leaves": len(a[0]) + len(a[1]), "moved": moved, "warnings": diag,
            "walls_ms": walls}


def determinism_paths(device_label) -> dict:
    """Phase 4n: one full-width step of each training path twice from one
    state (``step_twice``): VGG-16 (5-stage, bf16, ``from_cfg(train=True)``,
    2 images, one step taken first so that the momenta are live), the CFM
    step and the DP step at world 1 through NCCL on the same model, and the
    ResNet-101 COCO configuration's conv5 head (random FrozenBN leaves).
    Returns the launch counts of the phase by path (``determinism``)."""
    import torch.distributed as dist

    from mnc_tpu_torch.config import cfg
    from mnc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mnc_tpu_torch.models.cfm import make_cfm_train_step
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.parallel import data_parallel_train_step, make_mesh
    from mnc_tpu_torch.train.loop import (TrainState, draw_cfm_randoms, draw_step_randoms,
                                          make_train_step, train_cfg_from_cfg)
    from mnc_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    # the diagnostic sees an op that has no deterministic implementation
    probe = nondeterminism_warnings(lambda: torch.histc(torch.rand(64, device="cuda")))
    log(f"determinism: use_deterministic_algorithms warn_only on torch.histc (a probe): "
        f"{probe}")
    if not probe:
        raise AssertionError("determinism: the warn_only diagnostic caught no warning from "
                             "torch.histc")
    reset_launch_counts()

    def build(arch):
        model = MNC(arch, device="cuda", seed=0, train=True)
        opt = make_optimizer(model, base_lr=cfg.TRAIN.LEARNING_RATE,
                             momentum=cfg.TRAIN.MOMENTUM, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                             gamma=cfg.TRAIN.GAMMA, stepsize=cfg.TRAIN.STEPSIZE,
                             clip_gradients=cfg.TRAIN.CLIP_GRADIENTS)
        return model, opt, TrainState.create(model, opt), train_cfg_from_cfg(cfg)

    gen = torch.Generator(device="cuda").manual_seed(13)
    res = {}
    arch = MNCArch.from_cfg(train=True)
    model, opt, state, tc = build(arch)
    batch = _synthetic_batch(arch, [0, 1])
    step = make_train_step(model, opt, arch, tc)
    step(state, _synthetic_batch(arch, [2, 3]), gen)  # live momenta
    res["VGG-16"] = step_twice("VGG-16 (5-stage, bf16, 2 images)", model, opt, state, step,
                               batch, draw_step_randoms(gen, arch, tc, 2, 32))
    # CFM on the same network, each image's ground truth among its segments
    seg = {"seg_boxes": batch["gt_boxes"], "seg_masks": batch["gt_masks"].float(),
           "seg_valid": batch["gt_valid"]}
    cfm_tc = dict(tc, CFM_IOU=cfg.TRAIN.CFM_IOU)
    res["CFM"] = step_twice("CFM (VGG-16, bf16, 2 images, 32 segments each)", model, opt,
                            state, make_cfm_train_step(model, opt, arch, cfm_tc),
                            dict(batch, **seg),
                            draw_cfm_randoms(gen, arch, cfm_tc, 2, 32, 32))
    mesh = make_mesh(device="cuda")
    try:
        res["DP"] = step_twice("DP at world 1 (NCCL)", model, opt, state,
                               data_parallel_train_step(model, opt, arch, tc, mesh), batch,
                               draw_step_randoms(gen, arch, tc, 2, 32))
    finally:
        dist.destroy_process_group()
    del model, opt, state, step, mesh
    torch.cuda.empty_cache()
    with coco_cfg(True):
        arch = MNCArch.from_cfg(train=True)
        model, opt, state, tc = build(arch)
        randomize_frozen_bn(model, 3)
        batch = _synthetic_batch(arch, [0, 1])
        step = make_train_step(model, opt, arch, tc)
        step(state, _synthetic_batch(arch, [2, 3]), gen)
        res["ResNet-101 conv5"] = step_twice(
            "ResNet-101 COCO conv5 (bf16, 2 images)", model, opt, state, step, batch,
            draw_step_randoms(gen, arch, tc, 2, 32))
    del model, opt, state, step
    torch.cuda.empty_cache()
    counts = launch_counts()
    log(f"phase 4n (determinism) on {device_label}: {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    return {"determinism": counts}


CHECKS = {"roi_warp": check_roi_warp, "roi_warp_bwd": check_roi_warp_bwd, "nms": check_nms,
          "paste_binarize": check_paste, "block1": check_block1, "gemm_s8": check_gemm_s8,
          "quant_act": check_quant_act}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of mnc_tpu_torch on one GPU")
    ap.add_argument("--only", default=None, help="comma-separated kernels: build and "
                    "check only these, skip the main paths (for bringing a kernel up); "
                    "'parallel', 'tools' or 'determinism': build every kernel and run phase "
                    "4k, 4l and 4m, or 4n alone")
    ap.add_argument("--parallel-worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "INIT_FILE", "OUT_DIR"),
                    help="(internal) one rank of phase 4k's gloo group")
    args = ap.parse_args(argv)
    if args.parallel_worker:
        return parallel_worker(*args.parallel_worker)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build (the host helpers' g++ beside the nvcc processes)
    from concurrent.futures import ThreadPoolExecutor

    from mnc_tpu_torch import kernels, native

    phase_only = args.only in PHASES
    only = args.only.split(",") if args.only and not phase_only else None
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        lib = pool.submit(native.build)
        paths = kernels.build(only)
        lib = lib.result()
    log(f"build: {time.perf_counter() - t0:.1f} s; host helpers {lib.name} (g++ "
        f"{' '.join(native.CXX_FLAGS)})")
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        usage = [ln.strip() for ln in (log_path.read_text().splitlines()
                                       if log_path.exists() else []) if "registers" in ln]
        log(f"build {name}: " + ("; ".join(usage) or "cached"))

    if phase_only:
        by_path = main_paths(None, smi, only_phase=args.only)
        print(json.dumps({args.only: by_path}))
        return 0
    # phase 3: kernels against their plain versions
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {name: CHECKS[name](g) for name in (only or CHECKS)}
    if only:
        print(json.dumps({"checked": results}))
        return 0

    # phase 4: the main paths
    by_path = main_paths(g, smi)
    report_kernels(results, by_path, t_start)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


PHASES = ("parallel", "tools", "determinism")  # what --only runs alone, as a phase


def main_paths(g, smi, only_phase=None) -> dict:
    """Phase 4: each main path with the launch counters zeroed just before
    it and read just after; returns the counts by path.  ``only_phase``
    (one of ``PHASES``) runs phase 4k, 4l and 4m, or 4n alone."""
    from mnc_tpu_torch.models.mnc import MNCArch

    label = f"{torch.cuda.get_device_name(0)} ({smi})"
    vgg = MNCArch(pre_nms_top_n=6000, post_nms_top_n=304, nms_chunk=256,
                  compute_dtype=torch.bfloat16)
    if only_phase == "determinism":
        return determinism_paths(label)
    if only_phase:
        with tempfile.TemporaryDirectory() as tmp:
            if only_phase == "parallel":
                return parallel_paths(label, tmp)
            return tools_paths(label, tmp, vgg)
    by_path = {"serve": serve_path(label, "VGG-16", vgg)}
    arch = MNCArch.from_cfg(train=True)
    assert (arch.pre_nms_top_n, arch.post_nms_top_n, arch.fc_dim, arch.n_stages,
            arch.trunk_frozen) == (12000, 2000, 4096, 5, 2), arch
    by_path["train"], cont = train_path(label, "VGG-16", arch)
    by_path["train_fused_block1"] = fused_block1_path(*cont)
    del cont
    torch.cuda.empty_cache()
    for arch_kw in (None, RESNET_SMALL):
        small_model_agrees(arch_kw)
        small_train_step_agrees(arch_kw)
    for roi_conv5, name, n_requests in ((True, "resnet101_conv5", 2),
                                        (False, "resnet101_fc", 1)):
        with coco_cfg(roi_conv5):
            arch = MNCArch.from_cfg()
            assert (arch.trunk, arch.num_classes, arch.pre_nms_top_n, arch.post_nms_top_n,
                    arch.resnet_stride_in_3x3) == ("resnet101", 81, 6000, 304, False), arch
            by_path[f"serve_{name}"] = serve_path(label, f"ResNet-101 COCO ({name})", arch,
                                                  n_requests)
        torch.cuda.empty_cache()
    with coco_cfg(True) as cfg:
        arch = MNCArch.from_cfg(train=True)
        assert (arch.trunk, arch.roi_conv5, arch.pre_nms_top_n, arch.post_nms_top_n,
                arch.trunk_frozen, cfg.TRAIN.CLIP_GRADIENTS) == (
                    "resnet101", True, 12000, 2000, 2, 10.0), arch
        by_path["train_resnet101_conv5"], _ = train_path(label, "ResNet-101 COCO conv5", arch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        model = import_caffemodel(tmp)
        by_path["detect_many"], _ = stream_path(label, model)
        custom_op_overhead(g)
        entry_paths = serving_entry_points(label, model, tmp)
        by_path.update(entry_paths)
        del model
        torch.cuda.empty_cache()
        small_detect_many_agrees()
        test_net_agrees(tmp)

        # phase 4h: the CFM model family
        imdb = cfm_imdb()
        segdb = cfm_segdb(tmp, imdb)
        by_path["cfm_serve"] = cfm_serve_path(label, vgg, imdb, segdb)
        torch.cuda.empty_cache()
        by_path["cfm_train"] = cfm_train_path(label, imdb, segdb)
        torch.cuda.empty_cache()
        with coco_cfg(True):  # CFM on the ResNet-101 COCO trunk, conv5 head
            by_path["cfm_serve_resnet101_conv5"] = cfm_serve_path(
                label, MNCArch.from_cfg(), imdb, segdb, 2, "cfm_serve_resnet101_conv5")
        torch.cuda.empty_cache()
        by_path["cfm_serve_int8"] = cfm_serve_path(
            label, dataclasses.replace(vgg, int8_inference=True), imdb, segdb, 2,
            "cfm_serve_int8")
        torch.cuda.empty_cache()
        small_cfm_detect_agrees()
        small_cfm_train_step_agrees()
        test_net_segdb_agrees(tmp)
        torch.cuda.empty_cache()

        # phase 4i: int8 serving
        t0 = time.perf_counter()
        by_path["serve_int8"] = int8_serve_path(label, vgg)
        torch.cuda.empty_cache()
        by_path.update(int8_resnet_paths(label))
        for arch_kw in (None, RESNET_SMALL):
            small_int8_model_agrees(arch_kw)
        torch.cuda.empty_cache()
        log(f"phase 4i on {label}: {time.perf_counter() - t0:.1f} s in all")

        # phase 4j: real-format datasets, with phase 4f's caffemodel as --weights
        t0 = time.perf_counter()
        by_path.update(real_data_paths(label, tmp, os.path.join(tmp, "mnc_vgg16.caffemodel")))
        log(f"phase 4j on {label}: {time.perf_counter() - t0:.1f} s in all")
        torch.cuda.empty_cache()

        # phase 4k: parallel training and evaluation, on phase 4j's SBD tree
        by_path.update(parallel_paths(label, tmp))
        torch.cuda.empty_cache()

        # phase 4l: the train -> detect -> mAP^r tools, remat, voting, roi_pool
        by_path.update(tools_paths(label, tmp, vgg))
    torch.cuda.empty_cache()
    # phase 4n: two steps of every training path from one state, bit for bit
    by_path.update(determinism_paths(label))
    return by_path


def report_kernels(results, by_path, t_start) -> None:
    """Phase 5: every kernel launched on each path that must launch it;
    the ``kernels`` JSON line."""
    meta = {
        "roi_warp": ("roi_warp_cuda", "mnc_tpu_torch/csrc/roi_warp.cu",
                     "mnc_tpu/ops/pallas/roi_warp_kernel.py:142"),
        "roi_warp_bwd": ("roi_warp_bwd_cuda", "mnc_tpu_torch/csrc/roi_warp_bwd.cu",
                         "mnc_tpu/ops/pallas/roi_warp_kernel.py:175"),
        "nms": ("nms_keep_cuda", "mnc_tpu_torch/csrc/nms.cu",
                "mnc_tpu/ops/pallas/nms_kernel.py:65"),
        "paste_binarize": ("paste_binarize_cuda", "mnc_tpu_torch/csrc/paste.cu",
                           "mnc_tpu/ops/pallas/paste_kernel.py:92"),
        "block1": ("block1_cuda", "mnc_tpu_torch/csrc/block1.cu",
                   "mnc_tpu/ops/pallas/block1_kernel.py:172"),
        # no Pallas site: XLA's s8 convolution (dense: quant.py:108)
        "gemm_s8": ("gemm_s8_cuda", "mnc_tpu_torch/csrc/gemm_s8.cu",
                    "mnc_tpu/ops/quant.py:84"),
        # no Pallas site: what XLA fuses for _quant_act; with its two halves
        "quant_act": (("quant_act_cuda", "act_scale_cuda", "quant_with_scale_cuda"),
                      "mnc_tpu_torch/csrc/quant_act.cu", "mnc_tpu/ops/quant.py:43"),
    }
    # the paths that must launch each kernel
    serving = ("serve", "serve_resnet101_conv5", "serve_resnet101_fc")
    training = ("train", "train_resnet101_conv5")
    serving += ("detect_many", "serve_http", "serve_http_single", "exported")
    int8 = ("serve_int8", "serve_int8_resnet101_conv5", "serve_int8_resnet101_fc",
            "cfm_serve_int8")
    cfm = ("cfm_serve", "cfm_serve_resnet101_conv5", "cfm_serve_int8")
    real_train, real_test = ("train_voc", "train_coco"), ("test_voc", "test_voc_segdb",
                                                          "test_coco")
    # phase 4k: the parallel paths (the f32 spatial trunk runs convolutions only)
    real_train += ("train_dp", "dp_gloo", "tp_gloo", "train_dp_gloo")
    real_test += ("test_dp", "test_dp_int8", "test_dp_gloo")
    int8 += ("test_dp_int8",)
    # phase 4l: the tools (e2e_remat trains and evaluates)
    from mnc_tpu_torch.pipeline.inference import PostCfg
    from mnc_tpu_torch.tools.ablation_study import base_arch, parse_args, variants

    ablation = tuple(f"ablation_{v}" for v in variants(base_arch(parse_args([])), PostCfg()))
    real_train += ("e2e_train", "e2e_remat")
    real_test += ("e2e_eval", "e2e_int8_eval", "e2e_remat") + ablation
    int8 += ("e2e_int8_eval", "ablation_5stage_int8")
    # phase 4m: the study tools; phase 4n: every training path twice
    real_test += ("parity_test_net", "workingset", "crowd")
    training += ("determinism",)
    must = {"roi_warp": serving + training + int8 + cfm + ("cfm_train",) + real_train
            + real_test,
            "roi_warp_bwd": training + ("cfm_train",) + real_train,
            "nms": serving + training + int8 + cfm + real_train + real_test,
            "paste_binarize": serving + int8 + cfm + real_test,
            "block1": ("train_fused_block1", "spatial_block1"),
            "gemm_s8": int8 + ("spatial_int8",),
            "quant_act": int8 + ("spatial_int8",)}
    report = []
    for name, (wrappers, source, replaces) in meta.items():
        wrappers = (wrappers,) if isinstance(wrappers, str) else wrappers
        per_path = {path: sum(c[w] for w in wrappers) for path, c in by_path.items()}
        for path in must[name]:
            if per_path[path] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
        report.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                           launches=sum(per_path.values()), launches_by_path=per_path,
                           **results[name]))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": report}))


if __name__ == "__main__":
    sys.exit(main())
