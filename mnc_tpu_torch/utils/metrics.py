"""Structured training metrics — port of ``mnc_tpu/utils/metrics.py``:
JSONL step records (machine-diffable) and the reference's console line, in
place of Caffe's glog lines."""

from __future__ import annotations

import json
import os
import time
from typing import IO


class MetricsLogger:
    def __init__(self, path: str | None = None, print_every: int = 20):
        self.path = path
        self.print_every = print_every
        self._fh: IO | None = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, lr: float | None = None) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        if lr is not None:
            rec["lr"] = float(lr)
        rec.update({k: round(float(v), 6) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if step % self.print_every == 0:
            parts = ", ".join(f"{k} = {float(v):.4f}" for k, v in metrics.items())
            lr_s = f", lr = {lr:.6g}" if lr is not None else ""
            print(f"Iteration {step}{lr_s}: {parts}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
