"""Run one cell of the benchmark and print its result as the last line.

    python3 -m portbench.run --workload vgg16_voc.serve_b4 --seed 7 --seconds 10 --trace 0

Needs as many CUDA devices as the cell asks for and exits non-zero,
printing no result, without them.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy and window seconds and a breakdown of the trace.  The
comparison with the reference (``portbench/check.py``) decides ``correct``
in both; each number compared is printed beside its limit on standard
error and under ``checks`` in the line.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode of every module the run imports, cached at a fixed path
# inside the checkout: only a checkout's first run compiles it, also where
# the installed packages ship none and cannot be written to.
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / ".pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.manifest()
    work, _, _ = harness.resolve(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"portbench: the cell needs {work['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", process_start=PROCESS_START, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(harness.json_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
