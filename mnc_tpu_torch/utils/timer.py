"""Timers — port of ``mnc_tpu/utils/timer.py``: the reference's wall-clock
``Timer`` and a device timer on CUDA events."""

from __future__ import annotations

import time

import torch


class Timer:
    """Wall-clock accumulator with the reference's API (tic/toc/average_time)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


def device_timer(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of ``fn(*args)`` on the GPU, each call timed
    by CUDA events after ``warmup`` calls.  Raises without a GPU: a host
    clock would time the enqueue, not the work."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_timer needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    times.sort()
    return times[len(times) // 2]
