"""One rank of a ``torch.distributed`` gloo group on the CPU, for
``tests/test_torch_parallel*.py``.  Imports only torch and the port.

    python tests/torch_dist_worker.py SCENARIO INIT_FILE RANK WORLD IN_DIR OUT_DIR

``IN_DIR`` holds ``spec.json`` (the architecture, the solver and train
config, the scenario's options) and ``inputs.npz`` (the model's state dict
under ``sd/<name>``, the global batch under ``batch/<key>``, the draws
under ``draws/<field>/<i>``, images); each rank writes ``rank<R>.npz`` into
``OUT_DIR``.  Scenarios: ``dp`` (``data_parallel_train_step``), ``hybrid``
(``hybrid_parallel_train_step`` on a {data: 2, model: WORLD/2} mesh, with
a TP checkpoint), ``spatial`` (``spatial_trunk_features``; bf16 features
saved as f32), ``eval
(``data_parallel_eval_step``).  One torch thread per rank; the group times
out after 120 s rather than hang.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from mnc_tpu_torch.models.mnc import MNC, MNCArch  # noqa: E402
from mnc_tpu_torch.parallel import (data_parallel_eval_step, data_parallel_train_step,  # noqa: E402
                                    hybrid_parallel_train_step, init_distributed, make_mesh,
                                    replicate, shard_batch, shard_image, shard_train_state,
                                    spatial_trunk_features)
from mnc_tpu_torch.train.loop import StepDraws, TrainState  # noqa: E402
from mnc_tpu_torch.train.optim import make_optimizer  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_arch(kw: dict) -> MNCArch:
    kw = dict(kw)
    kw["compute_dtype"] = DTYPES[kw.get("compute_dtype", "float32")]
    for k in ("canvas", "anchor_scales"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return MNCArch(**kw)


def group(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
            if k.startswith(prefix)}


def load_model(arrays, arch, train: bool, prefix: str = "sd/", seed: int = 0) -> MNC:
    """The model of ``seed``, or the state dict under ``prefix`` where the
    inputs hold one."""
    model = MNC(arch, device="cpu", train=train, seed=seed)
    sd = group(arrays, prefix)
    if sd:
        model.load_state_dict(sd)
    return model


def load_draws(arrays) -> StepDraws:
    d = group(arrays, "draws/")
    return StepDraws(*(tuple(d[f"{f}/{i}"] for i in range(2)) for f in StepDraws._fields))


def train_state(arrays, spec):
    arch = make_arch(spec["arch"])
    model = load_model(arrays, arch, train=True, seed=spec.get("model_seed", 0))
    opt = make_optimizer(model, **spec.get("opt", {}))
    return arch, TrainState.create(model, opt)


def local_params(model, whole: bool) -> dict:
    """The parameters (``whole``), else a digest of each for the tests'
    bit-for-bit comparisons across ranks."""
    import hashlib

    return {f"sd/{k}": v.detach().numpy() if whole else
            np.asarray(hashlib.sha1(v.detach().numpy().tobytes()).hexdigest())
            for k, v in model.state_dict().items()}


def main(scenario, init_file, rank, world, in_dir, out_dir) -> None:
    rank, world = int(rank), int(world)
    with open(os.path.join(in_dir, "spec.json")) as f:
        spec = json.load(f)
    arrays = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout_s=120)
    out = {}
    if scenario in ("dp", "hybrid"):
        arch, state = train_state(arrays, spec)
        batch = group(arrays, "batch/")
        if scenario == "dp":
            mesh = make_mesh(device="cpu")
            replicate(state.model, mesh)
            step = data_parallel_train_step(state.model, state.opt, arch, spec["train_cfg"],
                                            mesh)
        else:
            from mnc_tpu_torch.parallel.tensor import save_checkpoint

            mesh = make_mesh({"data": 2, "model": world // 2}, device="cpu")
            shard_train_state(state, mesh)
            step = hybrid_parallel_train_step(state.model, state.opt, arch,
                                              spec["train_cfg"], mesh)
        draws = load_draws(arrays) if "draws/anchor/0" in arrays else \
            torch.Generator().manual_seed(spec["seed"])
        for _ in range(spec.get("steps", 1)):
            state, metrics = step(state, shard_batch(batch, mesh), draws)
        out.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
        out.update(local_params(state.model, rank in spec.get("whole_ranks", [0])))
        if scenario == "hybrid":
            save_checkpoint(os.path.join(out_dir, "ckpt"), state, mesh)
    elif scenario == "spatial":
        mesh = make_mesh(device="cpu")
        for name, arch_kw in spec["trunks"].items():
            model = load_model(arrays, make_arch(arch_kw), train=False, prefix=f"{name}/")
            fn = spatial_trunk_features(model, mesh)
            feat = fn(torch.from_numpy(shard_image(arrays["image"], mesh)))
            out[f"feat/{name}"] = feat.float().numpy()  # bf16 (kernel D's trunk) exactly
        try:
            shard_image(arrays["image"][:-16], mesh)
        except ValueError as e:
            out["bad_h_error"] = np.asarray(str(e))
    elif scenario == "eval":
        from mnc_tpu_torch.pipeline.inference import MNCPipeline, PostCfg

        model = load_model(arrays, make_arch(spec["arch"]), train=False,
                           seed=spec.get("model_seed", 0))
        mesh = make_mesh(device="cpu")
        if spec.get("runner") == "quant_act":  # an int8 layer's input quantization
            from mnc_tpu_torch.ops.quant import quant_act

            def runner(im, info):
                return dict(zip(("q", "scale"), quant_act(im, False)))
        else:
            pipe = MNCPipeline(model, PostCfg(**spec["post"]))
            runner = pipe.detect_canvas_packed
        fn = data_parallel_eval_step(runner, mesh)
        got = fn(torch.from_numpy(arrays["images"]), torch.from_numpy(arrays["infos"]))
        out.update({f"out/{k}": v.numpy() for k, v in got.items()})
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
