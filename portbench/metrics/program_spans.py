"""What the per-layer metrics read of the program's own spans
(``mnc_tpu_torch.utils.spans``; they record while the harness's profilers
record): the spans inside the device-only trace's window, the device time of
a span a request, the device's idle time while the host was inside a span a
request, and the set-up spans' seconds.

Each reader returns ``None`` where there is nothing to read: no device trace
(a run on the CPU), no request in the window, or a program without spans.

A gap metric counts all idle time under its span's host ranges, its child
spans' included: ``request_gap_ms`` covers ``trunk_gap_ms`` and
``heads_gap_ms``, and what the idle share holds beyond ``request_gap_ms``
falls in the harness's own loop.  The idle time under a set of ranges is
what the ranges add to the device's busy union.
"""

from __future__ import annotations

from portbench.trace import Trace

REQUEST = "mnc.request"


def _spans():
    """The program's span module, or ``None`` for a program that has none."""
    try:
        from mnc_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def in_window(trace, records) -> list:
    """The spans that start and end inside the trace's window."""
    return [s for s in records if trace.start_ns <= s.start_ns and s.end_ns <= trace.end_ns]


def idle_under_ns(trace, ranges) -> int:
    """Nanoseconds of the window in which the device ran nothing and the
    host was inside one of ``ranges``."""
    covered = Trace(trace.start_ns, trace.end_ns,
                    list(trace.device) + [(s, e, "") for s, e in ranges], [])
    return sum(e - s for s, e in covered.busy_intervals()) - sum(
        e - s for s, e in trace.busy_intervals())


def device_ms(trace, records, name: str) -> float | None:
    """Device milliseconds of the spans ``name`` a request of the window."""
    spans = in_window(trace, records)
    n = sum(s.name == REQUEST for s in spans)
    timed = [s.device_ms() for s in spans if s.name == name]
    if n == 0 or not timed or None in timed:
        return None
    return sum(timed) / n


def gap_ms(trace, records, name: str) -> float | None:
    """Device idle milliseconds a request of the window under the host
    ranges of the spans ``name``."""
    spans = in_window(trace, records)
    n = sum(s.name == REQUEST for s in spans)
    ranges = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
    if n == 0 or not ranges:
        return None
    return idle_under_ns(trace, ranges) / 1e6 / n


def read_device_ms(ctx, name: str) -> float | None:
    spans = _spans()
    if spans is None or ctx.trace is None:
        return None
    return device_ms(ctx.trace, spans.records(), name)


def read_gap_ms(ctx, name: str) -> float | None:
    spans = _spans()
    if spans is None or ctx.trace is None:
        return None
    return gap_ms(ctx.trace, spans.records(), name)


def read_setup_s(ctx, name: str) -> float | None:
    """Host seconds of the process's first set-up span ``name`` (the served
    model's build; the served pipeline's first request)."""
    spans = _spans()
    if spans is None or ctx.trace is None:
        return None
    first = next((s for s in spans.setup_records() if s.name == name), None)
    return None if first is None else (first.end_ns - first.start_ns) / 1e9
