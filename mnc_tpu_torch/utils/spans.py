"""Named spans of the serving path, on the host clock of the profiler's trace.

``MNCPipeline._run_batch`` opens ``mnc.request`` around a batch, which
takes a new request id; inside it ``MNC.apply_batch`` opens ``mnc.trunk``,
``mnc.propose`` (RPN head and proposals) and ``mnc.heads`` (once a head
pass, the RoI warp included), and ``_run_batch`` opens ``mnc.pack`` around
``pack_bits``.

Spans record after ``enable(True)`` and while a ``torch.profiler`` records;
otherwise ``span`` hands back one shared no-op context manager after a flag
check.  A span keeps its name, the request id of the enclosing
``mnc.request``, its parent span (per thread: the server runs batches on a
worker thread), and its host start and end from ``time.time_ns()``, the
clock that the profiler's (Kineto's) timestamps are on.  Given a CUDA device
it records a pair of timing events on the current stream; ``Span.device_ms``
reads them after the fact.  Only spans turned on by ``enable(True)`` open a
profiler range of their name (what ``record_function`` opens, at a tenth of
its cost), so that a profile taken then names the layers; a profile taken
without it holds the same events as with no spans at all.
A span is a no-op while ``torch.compile`` or ``torch.export`` traces and
while the current stream captures a CUDA graph.  The newest ``MAX_RECORDS``
spans stay in memory until ``reset()``; nothing is written out.

Two set-up spans are kept whether spans are on or not, on the host clock
only, the first of each name since ``reset()``: ``mnc.build`` (all of
``MNC.__init__``) and ``mnc.first_request`` (the first batch served).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 15  # ~4,600 requests of 7 spans
_on = False
_NOOP = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_setup: dict = {}
_request_ids = itertools.count(1)
_local = threading.local()


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    request: int | None
    parent: Span | None
    start_ns: int
    end_ns: int = 0
    events: tuple | None = None  # (start, end) CUDA events of a device span

    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on its stream; waits
        for the second.  ``None`` for a span without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def enable(on: bool) -> None:
    """Turn the spans and their profiler ranges on or off."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Forget every record, the set-up spans included."""
    _records.clear()
    _setup.clear()


def records() -> list[Span]:
    """The spans recorded since the last ``reset()``, in order of start."""
    return list(_records)


def setup_records() -> list[Span]:
    """The set-up spans since the last ``reset()``, in order of end."""
    return list(_setup.values())


def span(name: str, device=None, *, request: bool = False):
    """A context manager that records the span ``name``; with a CUDA
    ``device``, timed by events on the current stream too; with
    ``request``, the root of a new request."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    if torch.compiler.is_compiling() or (torch.cuda.is_initialized()
                                         and torch.cuda.is_current_stream_capturing()):
        return _NOOP
    return _Recording(name, device, request)


class _Recording:
    """The context manager of a span that records."""

    __slots__ = ("name", "device", "request", "span", "range")

    def __init__(self, name: str, device, request: bool):
        self.name, self.device, self.request = name, device, request

    def __enter__(self) -> Span:
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        rid = next(_request_ids) if self.request else (parent.request if parent else None)
        sp = self.span = Span(self.name, rid, parent, time.time_ns())
        _records.append(sp)
        stack.append(sp)
        # the profiler's low-overhead range (the one compiled code enters)
        self.range = (_RecordFunctionFast(self.name)
                      if _on and _profiler._is_profiler_enabled else None)
        if self.range is not None:
            self.range.__enter__()
        if self.device is not None and torch.device(self.device).type == "cuda":
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self.span
        if sp.events is not None:
            sp.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        sp.end_ns = time.time_ns()
        _local.stack.pop()


def setup_span(name: str):
    """A set-up span on the host clock, kept whether spans are on or not;
    the shared no-op once a span of this name has been kept."""
    return _NOOP if name in _setup else _SetupRecording(name)


class _SetupRecording:
    __slots__ = ("span",)

    def __init__(self, name: str):
        self.span = Span(name, None, None, 0)

    def __enter__(self) -> Span:
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        _setup.setdefault(self.span.name, self.span)
