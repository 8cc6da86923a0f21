"""Export trained weights to deployment params (npz) and, optionally, the
inference program — the port's counterpart of ``tools/export_model.py``.

Folds the bbox-target normalization stats into the ``bbox_pred`` weights
(the reference ``SolverWrapper.snapshot`` semantics), so the exported model
emits raw deltas, and writes a flat npz (the ``.caffemodel`` role).

    python3 -m mnc_tpu_torch.tools.export_model (--ckpt DIR | --npz PATH) \\
        [--out model.npz] [--no-unnormalize] [--program PATH [--program-batch B]] \\
        [--cfg FILE] [--set KEY VAL ...] [--device cpu]

``--ckpt`` takes a step directory of ``train_net`` or the run directory (its
newest step); ``--npz`` a ``save_npz`` export or a train state (an npz whose
stats are folded in already is written as it is).  ``--program`` also
writes the whole canvas-space inference program as a ``torch.export``
artifact (``pipeline/export.py``) with the checkpoint's own weights and the
matching arch, as ``serve --ckpt`` runs them; ``--program-batch B`` exports
the batched program instead of the single-image one.  The artifact runs on
the device it is exported on (``--device``, default ``cuda``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Export MNC weights (PyTorch port)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="train_net checkpoint: a ckpt_<step> dir or the run dir")
    src.add_argument("--npz", help="save_npz export or train_net state")
    ap.add_argument("--out", default=None,
                    help="output .npz (default from TRAIN.SNAPSHOT_PREFIX)")
    ap.add_argument("--no-unnormalize", action="store_true")
    ap.add_argument("--program", default=None, metavar="PATH",
                    help="also write the full inference program (weights inside) as a "
                         "torch.export artifact")
    ap.add_argument("--program-batch", type=int, default=None, metavar="B",
                    help="export the batched (B-image) program instead of the "
                         "single-image one")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, for --program")
    args = ap.parse_args(argv)

    from mnc_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.utils.checkpoint import (checkpoint_npz, export_params,
                                                load_import_weights, npz_meta, save_npz)

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    path = checkpoint_npz(args.ckpt) if args.ckpt else args.npz
    params, arch = load_import_weights(None, path, MNCArch.from_cfg(train=False), None)
    out = params
    normalized = arch.bbox_pred_normalized
    if normalized and not args.no_unnormalize:
        out = export_params(out, cfg.TRAIN.BBOX_NORMALIZE_MEANS, cfg.TRAIN.BBOX_NORMALIZE_STDS)
        normalized = False
        print("folded bbox normalization stats into bbox_pred")
    out_path = args.out
    if out_path is None:
        # reference snapshot naming: {prefix}{infix}_iter_{N}.caffemodel
        step = int(npz_meta(path).get("step", 0))
        out_path = f"{cfg.TRAIN.SNAPSHOT_PREFIX}{cfg.TRAIN.SNAPSHOT_INFIX}_iter_{step}.npz"
    # the regressor convention rides along, so npz consumers configure the
    # stage bridge correctly
    save_npz(out_path, out, meta={"bbox_pred_normalized": normalized})
    print(f"exported {path} → {out_path}")

    if args.program:
        from mnc_tpu_torch.models.mnc import MNC
        from mnc_tpu_torch.pipeline.export import export_inference, save_exported
        from mnc_tpu_torch.pipeline.inference import PostCfg
        from mnc_tpu_torch.utils.checkpoint import state_dict_from_jax
        from mnc_tpu_torch.utils.device import resolve_device

        model = MNC(arch, device=resolve_device(args.device))
        model.load_state_dict(state_dict_from_jax(params))
        blob = export_inference(model, PostCfg.from_cfg(), batch=args.program_batch)
        save_exported(args.program, blob)
        shape = f"batch={args.program_batch}" if args.program_batch else "single-image"
        print(f"exported {shape} inference program → {args.program} "
              f"({len(blob) / 1e6:.1f} MB, {model.device.type})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
