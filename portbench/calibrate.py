"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 -m portbench.calibrate --workload vgg16_voc.serve_b4 --seconds 2 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--out FILE]

Runs the cell as the benchmark does (the same window, traffic and
comparison, with every limit open) on each of ``--seeds``, then the control
on each of ``--control-seeds``: the same cell with the port's own
lower-precision path switched on (``TEST.INT8``: every trunk convolution,
the conv5 head's and the fc layers in int8 through kernels E and F), in
one process.  Prints one JSON line a run and, at the end, the largest
reading of the program and the smallest of the control for each number.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from portbench import check, harness


def readings(cell: str, seeds, seconds: float, control: bool, device="cuda"):
    """[(seed, numbers, result)] of runs of ``cell`` with every limit open;
    ``control`` switches the port's int8 path on."""
    open_limits = {k: math.inf for k in check.NUMBERS}

    def int8_path(config: dict, traffic: dict) -> None:
        config["net"]["int8"] = True
    out = []
    for seed in seeds:
        res = harness.run(cell, seed, seconds, False, device=device,
                          adjust=int8_path if control else None, limits=open_limits)
        out.append((seed, {k: res["checks"][k]["value"] for k in check.NUMBERS}, res))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed, nums, res in readings(args.workload, seeds, args.seconds, control):
            row = {"control": control, "seed": seed, "numbers": nums,
                   "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
            rows.append(row)
            print(harness.json_line(row), flush=True)
    summary = {}
    for k in check.NUMBERS:
        prog = [r["numbers"][k] for r in rows if not r["control"]]
        ctrl = [r["numbers"][k] for r in rows if r["control"]]
        summary[k] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
    print(harness.json_line({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(harness.json_line(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
