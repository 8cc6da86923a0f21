"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy intervals, the device time of kernels by name, and
where the device sat idle and what the host did meanwhile.

Everything comes from the profiler's raw (Kineto) events, whose host and
device timestamps share one clock: device activity is every event on the
CUDA device (kernels, copies, fills), and a kernel is known by its name.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    device: list  # (start_ns, end_ns, name)
    host: list  # (start_ns, end_ns, name, thread id)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of device activity inside the window, merged."""
        iv = sorted((max(s, self.start_ns), min(e, self.end_ns)) for s, e, _ in self.device
                    if e > self.start_ns and s < self.end_ns)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels_s(self, names) -> float:
        """Device seconds inside the window of the kernels whose name
        contains any of ``names`` (the program's kernel names)."""
        return sum(min(e, self.end_ns) - max(s, self.start_ns) for s, e, n in self.device
                   if e > self.start_ns and s < self.end_ns and any(k in n for k in names)) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time (a
        templated kernel's name cut to its first 200 characters)."""
        by = {}
        for s, e, name in self.device:
            d = min(e, self.end_ns) - max(s, self.start_ns)
            if d > 0:
                by[name] = by.get(name, 0) + d
        return [[n[:200], t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] for the idle gaps of the device,
        summed by the innermost host event under each gap's middle."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        tids = {}
        for *_, tid in self.host:
            tids[tid] = tids.get(tid, 0) + 1
        main = max(tids, key=tids.get) if tids else None
        events = sorted(((s, e, n) for s, e, n, tid in self.host if tid == main),
                        key=lambda x: (x[0], -x[1]))
        by, stack, j = {}, [], 0
        for gs, ge in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (gs + ge) // 2
            while j < len(events) and events[j][0] <= mid:
                while stack and stack[-1][1] < events[j][0]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            inner = next((ev for ev in reversed(stack) if ev[0] <= mid <= ev[1]), None)
            key = inner[2] if inner else "host outside any traced event"
            by[key] = by.get(key, 0) + (ge - gs)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]


def from_profiler(prof, start_ns: int, end_ns: int) -> Trace:
    """A :class:`Trace` of the window [start_ns, end_ns] (``time.time_ns``)."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type())
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind.endswith("CUDA"):
            device.append((s, e, ev.name()))
        elif kind.endswith("CPU"):
            host.append((s, e, ev.name(), ev.start_thread_id()))
    return Trace(start_ns, end_ns, device, host)
