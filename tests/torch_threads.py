"""Torch's CPU threads for the port's tests under pytest-xdist.

The suite runs in several pytest-xdist worker processes on one machine
(``-n 6 --dist loadfile``).  Left alone, torch in each worker starts one
OpenMP thread per core, so the workers' threads outnumber the cores several
times over and torch's CPU kernels spend their time waiting for each other:
six workers on eight cores ran the same ResNet tests 8x slower than with one
thread each.  Every ``tests/test_torch_*.py`` imports this module, which
gives each worker its share of the cores (at least one thread).  Outside
xdist it changes nothing.  The thread count changes no selection a test
checks; torch's parallel reductions may sum in another order, which the
float comparisons' tolerances cover, and a test that compares torch's output
bit for bit with another process gives that process the same count.
"""

import os

import torch


def worker_threads() -> int | None:
    """cores // workers under xdist (at least 1), else None."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())
