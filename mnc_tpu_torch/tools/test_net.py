"""Evaluate MNC — the port's counterpart of ``tools/test_net.py`` (≙ the
reference ``tools/test_net.py`` + TesterWrapper).

Runs the detection pipeline over an imdb, caches the raw detections, and
prints mAP^r @0.5/0.7 with the reference-style per-class AP table.

    python3 -m mnc_tpu_torch.tools.test_net --imdb synthetic_16 \\
        [--npz PATH | --ckpt DIR | --caffemodel PATH [--remap OLD=NEW ...]] [--stages 5] \\
        [--cfg FILE] [--set KEY VAL ...] [--conf 0.0] [--eval-batch N] \\
        [--cache out.pkl] [--coco-ap] [--segdb DIR [--seg-top-k 300]] [--device cpu] \\
        [--dp [--dist-init URL] [--dist-backend gloo]]

``--imdb`` is any name ``data.imdb.get_imdb`` resolves: ``synthetic[_<n>]``
(whose images are canvases already; the architecture shrinks to them),
``voc_2012_seg_<set>`` (SBD) or ``coco_<split>`` under ``cfg.DATA_DIR``, or a
registered name.  A real imdb takes ``MNCArch.from_cfg`` (the canvas of
``cfg.STATIC.CANVAS``) with the imdb's class count; each image is read by
``data.loader.load_image`` (PNG without cv2, anything else with it) and
goes through ``MNCPipeline.detect``, whose full-resolution masks are
evaluated against the imdb's ground truth.  ``--npz`` reads a ``save_npz``
export or the port's ``train_net`` state; ``--ckpt`` a step directory of
``train_net`` or the newest one under a run directory.  ``--segdb DIR``
evaluates in CFM mode (``models/cfm.py``): each image's top
``--seg-top-k`` precomputed segment proposals (the records of
``tools.prepare_mcg_maskdb``, in image coordinates) are classified by the
trunk and the classify head instead of running the RPN, one image at a time
(``cfm_detect``); a real image is scaled and padded into the canvas
(``prep_im_for_blob``), its segments scaled alike, and the canvas masks
cropped to the image's extent and resized back to it.  ``--coco-ap`` adds
the COCO-style AP^r@[.5:.95].  It runs on the GPU unless ``--device cpu``
is given, and raises without one.

``--dp`` shards each batch of ``--eval-batch`` canvases (a multiple of the
world size) of a synthetic imdb over the processes of a
``torch.distributed`` group (``parallel.data_parallel_eval_step``; the
group as ``train_net --dp`` joins it, a one-rank group without a
launcher), as the JAX tool's ``--dp`` does: each rank runs its images one
at a time (so that under ``TEST.INT8`` each activation scale covers one
image, as the JAX step's per-image runner does), rank 0 gathers the
detections and evaluates.

    torchrun --nproc-per-node N -m mnc_tpu_torch.tools.test_net --dp --eval-batch 8 ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

from mnc_tpu_torch.tools.train_net import add_dp_args, dp_setup


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Test MNC (PyTorch port)")
    ap.add_argument("--imdb", default="synthetic_16")
    ap.add_argument("--npz", default=None,
                    help="save_npz export or train_net state (params/... names)")
    ap.add_argument("--ckpt", default=None,
                    help="train_net checkpoint: a ckpt_<step> dir or the run dir (newest)")
    ap.add_argument("--caffemodel", default=None, help="reference .caffemodel weights")
    ap.add_argument("--remap", nargs="*", default=None, metavar="OLD=NEW",
                    help="rename caffemodel layers before matching")
    ap.add_argument("--coco-ap", action="store_true",
                    help="also report COCO-style AP^r@[.5:.95]")
    ap.add_argument("--eval-batch", type=int, default=1,
                    help="detect images in device batches of N")
    ap.add_argument("--stages", type=int, default=5, choices=(3, 5))
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--conf", type=float, default=0.0)
    ap.add_argument("--cache", default=None, help="pickle path for raw detections")
    ap.add_argument("--segdb", default=None,
                    help="CFM mode: dir of per-image segment-proposal pkls "
                         "(mnc_tpu_torch.tools.prepare_mcg_maskdb)")
    ap.add_argument("--seg-top-k", type=int, default=300,
                    help="--segdb: segment proposals per image (padded)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_dp_args(ap)
    return ap.parse_args(argv)


def build_pipeline(arch, device, caffemodel=None, npz=None, remap=None, post=None):
    """MNCPipeline for ``arch`` on ``device`` with imported weights (or the
    seeded random init, with a warning).  Returns (pipeline, arch): the arch
    may change with the weights (``load_import_weights``)."""
    from mnc_tpu_torch.models.mnc import MNC
    from mnc_tpu_torch.pipeline.inference import MNCPipeline
    from mnc_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                load_import_weights, state_dict_from_jax)

    def make_params(a):
        return jax_params_from_state_dict(MNC(a, device="cpu", train=True).state_dict())

    if caffemodel or npz:
        params, arch = load_import_weights(caffemodel, npz, arch,
                                           None if npz else make_params(arch),
                                           remap=remap, make_params=make_params)
        model = MNC(arch, device=device)
        model.load_state_dict(state_dict_from_jax(params))
        print(f"loaded params from {caffemodel or npz}")
    else:
        print("WARNING: random weights (plumbing smoke)")
        model = MNC(arch, device=device)
    return MNCPipeline(model, post), arch


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    if not args.dp:
        return _test(args, device, None)
    if args.segdb or not args.imdb.startswith("synthetic"):
        raise SystemExit("--dp shards the canvas batches of a synthetic imdb "
                         "(not --segdb or a real imdb)")
    mesh, device, own_group = dp_setup(args, device)
    try:
        if args.eval_batch % mesh.size():
            raise SystemExit(f"--dp: --eval-batch {args.eval_batch} must be a multiple of "
                             f"the {mesh.size()} ranks")
        return _test(args, device, mesh)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _test(args, device, mesh) -> int:
    import numpy as np
    import torch

    from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mnc_tpu_torch.data.eval_sds import collect_detections, print_ap_table
    from mnc_tpu_torch.data.imdb import get_imdb
    from mnc_tpu_torch.data.loader import load_image, load_segments
    from mnc_tpu_torch.models.cfm import cfm_detect
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.pipeline.inference import (PostCfg, _resize_mask_to,
                                                  unpack_canvas_masks)
    from mnc_tpu_torch.utils.blob import prep_im_for_blob
    from mnc_tpu_torch.utils.checkpoint import checkpoint_npz
    from mnc_tpu_torch.utils.timer import Timer

    lead = mesh is None or mesh.get_rank() == 0  # evaluates and prints
    say = print if lead else (lambda *a, **k: None)
    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    imdb = get_imdb(args.imdb)
    synthetic = args.imdb.startswith("synthetic")
    if synthetic:
        arch = MNCArch.from_cfg(train=False, n_stages=args.stages, canvas=imdb.gen.canvas_hw,
                                num_classes=imdb.num_classes, anchor_scales=(2, 4, 8),
                                rpn_min_size=4.0)
    else:
        arch = MNCArch.from_cfg(train=False, n_stages=args.stages,
                                num_classes=imdb.num_classes)
    npz = checkpoint_npz(args.ckpt) if args.ckpt and not args.npz else args.npz
    pipe, arch = build_pipeline(arch, device, args.caffemodel, npz, args.remap,
                                PostCfg.from_cfg(score_thresh=args.conf))

    def host(out):
        return {k: v.cpu().numpy() for k, v in out.items()}

    detections: list = []
    timer = Timer()
    pending: list = []

    if mesh is not None:
        from mnc_tpu_torch.parallel import data_parallel_eval_step

        run_batch = data_parallel_eval_step(pipe.detect_canvas_packed, mesh)
        say(f"--dp: eval batches of {args.eval_batch} sharded over {mesh.size()} devices")
    else:
        run_batch = pipe.detect_canvas_batch_packed

    def flush_batch():
        # pad the tail batch to the batch size by repeating the last image
        entries = pending + [pending[-1]] * (args.eval_batch - len(pending))
        timer.tic()
        outs = host(run_batch(*(torch.as_tensor(np.stack([e[j] for e in entries]),
                                                device=device) for j in (1, 2))))
        timer.toc()
        for k, (i, _, _) in enumerate(pending):
            out = unpack_canvas_masks({key: v[k] for key, v in outs.items()}, arch.canvas[1])
            detections.extend(collect_detections(out, i, args.conf))
        pending.clear()

    if args.cache and osp.exists(args.cache):
        with open(args.cache, "rb") as f:
            detections = pickle.load(f)  # a file this tool wrote
        say(f"loaded {len(detections)} cached detections from {args.cache}")
    else:
        for n, i in enumerate(imdb.image_index):
            if synthetic:
                ex = imdb.example(i)
                canvas, info = ex["image"], ex["im_info"]
            else:
                im = load_image(imdb, n)
            if args.segdb:
                timer.tic()
                if not synthetic:  # scaled and padded on the model's device
                    canvas, info = prep_im_for_blob(im, target_size=cfg.TEST.SCALES[0],
                                                    max_size=cfg.TEST.MAX_SIZE,
                                                    canvas_hw=tuple(arch.canvas),
                                                    device=device)
                boxes, masks, valid, _ = load_segments(args.segdb, i, args.seg_top_k,
                                                       cfg.MASK_SIZE)
                boxes = boxes * float(info[2])  # segdb boxes are image coordinates
                out = cfm_detect(pipe.model, canvas, info, boxes, masks, valid, pipe.post)
                if not synthetic:  # unmold: crop to the image's extent, resize back
                    sh, sw = int(info[0]), int(info[1])
                    out["canvas_masks"] = _resize_mask_to(out["canvas_masks"][:, :sh, :sw],
                                                          im.shape[:2])
                    out["boxes"] = out["boxes"] / float(info[2])
                out = host(out)
                timer.toc()
                detections.extend(collect_detections(out, i, args.conf))
                continue
            if not synthetic:
                timer.tic()
                out = pipe.detect(im)
                timer.toc()
                out["canvas_masks"] = out["full_masks"]
                detections.extend(collect_detections(out, i, args.conf))
            elif args.eval_batch > 1 or mesh is not None:
                pending.append((i, canvas, info))
                if len(pending) == args.eval_batch or n == imdb.num_images - 1:
                    flush_batch()
                continue
            else:
                timer.tic()
                out = host(pipe.detect_canvas(canvas, info))
                timer.toc()
                detections.extend(collect_detections(out, i, args.conf))
            if (n + 1) % 50 == 0:
                say(f"im_detect: {n + 1}/{imdb.num_images} {timer.average_time:.3f}s/im")
        if args.cache and lead:
            os.makedirs(osp.dirname(args.cache) or ".", exist_ok=True)
            with open(args.cache, "wb") as f:
                pickle.dump(detections, f)

    if not lead:  # rank 0 evaluates the gathered detections
        return 0
    threshs = (0.5, 0.7, "avg") if args.coco_ap else (0.5, 0.7)
    results = imdb.evaluate(detections, iou_threshs=threshs)
    for res in results.values():
        print(print_ap_table(res, imdb.classes))
    line = (f"mAP^r@0.5 = {results[0.5]['map']:.4f}  "
            f"mAP^r@0.7 = {results[0.7]['map']:.4f}")
    if args.coco_ap:
        line += f"  AP^r@[.5:.95] = {results['avg']['map']:.4f}"
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
