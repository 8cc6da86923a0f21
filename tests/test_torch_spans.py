"""The port's spans (``mnc_tpu_torch/utils/spans.py``) and what the
benchmark reads of them (``portbench/metrics/program_spans.py``).

- Off, ``span`` hands back one shared no-op and records nothing; on (by
  ``enable`` or under a profiler), nested spans carry their request id and
  parent, per thread, with ordered host times, and only the newest
  ``MAX_RECORDS`` are kept; only ``enable`` opens profiler ranges; the
  set-up spans are kept once each, the first of each name, on or off.
- ``_run_batch`` of the small CPU configuration of ``portbench/tests/small.py``
  (5 stages, f32) gives one ``mnc.request``, ``mnc.trunk``, ``mnc.propose``
  and ``mnc.pack`` a request and two ``mnc.heads``; its outputs are bit for
  bit the same with spans on and off, and ``torch.export`` traces the same
  graph either way.
- The gap and device-time helpers and the seven readers on a synthetic
  trace with known overlaps.
- On the card (marker ``cuda``): a profile taken with spans recording but
  not enabled (as the harness's are) holds no event of theirs, host or
  device; one taken after ``enable`` holds their ranges.  The program's clock is the traces' host
  clock, and every kernel of a traced window of ``vgg16_voc.serve_b4`` lies
  between its request's ``mnc.request`` start and the next request's start:
  its launch call on the host clock, and the kernel on the device timeline
  once that is put after its launch calls.
"""

import bisect
import collections
import sys
import threading
import types

import pytest
import torch

from mnc_tpu_torch.utils import spans
from portbench import generator, harness, weights
from portbench.metrics import program_spans, reader
from portbench.tests.small import SEED, small
from portbench.trace import Trace
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

PER_REQUEST = {"mnc.request": 1, "mnc.trunk": 1, "mnc.propose": 1, "mnc.heads": 2,
               "mnc.pack": 1}
READERS = ("propose_ms", "pack_ms", "request_gap_ms", "trunk_gap_ms", "heads_gap_ms",
           "model_build_s", "first_request_s")


@pytest.fixture(autouse=True)
def spans_off():
    spans.enable(False)
    yield
    spans.enable(False)


@pytest.fixture(scope="module")
def served():
    """The small pipeline, built and run twice with spans off; the set-up
    records those three steps left."""
    spans.enable(False)
    spans.reset()
    _, config, traffic = harness.resolve("vgg16_voc.serve_b4", harness.manifest())
    small("float32")(config, traffic)
    net, post = config["net"], config["post"]
    dev = torch.device("cpu")
    pipe = harness.build_system(net, post, weights.draw(net, SEED, dev, torch.float32), dev)
    pool = generator.make_pool(traffic, net["canvas"], SEED, dev)
    inputs = [(pool.canvases[i], pool.im_info[i]) for i in range(2)]
    off = [pipe.detect_canvas_batch_packed(x, info) for x, info in inputs]
    return types.SimpleNamespace(pipe=pipe, inputs=inputs, off=off,
                                 setup=spans.setup_records(), records=spans.records())


def test_off_records_nothing_and_hands_back_the_shared_noop():
    spans.reset()
    a, b = spans.span("mnc.request", request=True), spans.span("mnc.pack", "cpu")
    assert a is b is spans._NOOP
    with a, b:
        pass
    assert spans.records() == []


def test_on_nested_spans_carry_request_and_parent():
    spans.reset()
    spans.enable(True)
    with spans.span("mnc.request", request=True) as r1:
        with spans.span("mnc.trunk") as t1:
            with spans.span("inner", "cpu") as i1:
                pass
    with spans.span("mnc.request", request=True) as r2:
        with spans.span("mnc.heads") as h2:
            pass
    spans.enable(False)
    with spans.span("mnc.request", request=True):
        pass
    assert spans.records() == [r1, t1, i1, r2, h2]
    assert r1.request != r2.request and r1.parent is None and r2.parent is None
    assert (t1.request, t1.parent, i1.request, i1.parent) == (r1.request, r1, r1.request, t1)
    assert (h2.request, h2.parent) == (r2.request, r2)
    assert i1.events is None  # no device events on the CPU
    for outer, inner in ((r1, t1), (t1, i1), (r2, h2)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert r1.end_ns <= r2.start_ns


def test_parents_are_kept_per_thread():
    spans.reset()
    spans.enable(True)
    opened = threading.Barrier(2, timeout=30)
    got = {}

    def serve(key):
        with spans.span("mnc.request", request=True) as r:
            opened.wait()  # both requests are open before either opens a child
            with spans.span("mnc.trunk") as t:
                opened.wait()
            got[key] = (r, t)

    threads = [threading.Thread(target=serve, args=(k,)) for k in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and set(got) == {"a", "b"}
    (ra, ta), (rb, tb) = got["a"], got["b"]
    assert ta.parent is ra and tb.parent is rb and ra.request != rb.request
    assert (ta.request, tb.request) == (ra.request, rb.request)
    assert len(spans.records()) == 4


def test_spans_follow_the_profiler():
    """Under a profiler spans record, but open profiler ranges only when
    ``enable`` turned them on: a profile taken without it (the harness's)
    holds the same events as with no spans."""
    def profiled():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with spans.span("mnc.request", request=True):
                with spans.span("mnc.trunk"):
                    torch.ones(3).sum()
        return {e.key for e in prof.key_averages()}

    for on in (False, True):
        spans.reset()
        spans.enable(on)
        names = profiled()
        assert [s.name for s in spans.records()] == ["mnc.request", "mnc.trunk"]
        if on:
            assert {"mnc.request", "mnc.trunk"} <= names
        else:
            assert not any(n.startswith("mnc.") for n in names)
    spans.enable(False)
    spans.reset()
    with spans.span("mnc.request", request=True):
        pass
    assert spans.records() == []


def test_only_the_newest_records_are_kept(monkeypatch):
    assert spans._records.maxlen == spans.MAX_RECORDS
    monkeypatch.setattr(spans, "_records", collections.deque(maxlen=3))
    spans.enable(True)
    for i in range(5):
        with spans.span(f"s{i}"):
            pass
    assert [s.name for s in spans.records()] == ["s2", "s3", "s4"]


def test_setup_spans_keep_the_first_of_each_name():
    spans.reset()
    with spans.setup_span("a") as a1:
        pass
    assert spans.setup_span("a") is spans._NOOP
    with spans.setup_span("b") as b1:
        pass
    spans.enable(True)
    assert spans.setup_span("a") is spans._NOOP
    assert spans.setup_records() == [a1, b1] and spans.records() == []
    assert a1.start_ns <= a1.end_ns <= b1.start_ns <= b1.end_ns
    spans.reset()
    assert spans.setup_records() == [] and spans.setup_span("a") is not spans._NOOP


def test_setup_spans_are_recorded_once_each_with_spans_off(served):
    assert served.records == []
    assert [s.name for s in served.setup] == ["mnc.build", "mnc.first_request"]
    for s in served.setup:
        assert s.request is None and s.parent is None and 0 < s.start_ns < s.end_ns
    build, first = served.setup
    assert build.end_ns <= first.start_ns


def test_run_batch_spans_per_request_and_outputs_unchanged(served):
    spans.reset()
    spans.enable(True)
    on = [served.pipe.detect_canvas_batch_packed(x, info) for x, info in served.inputs]
    spans.enable(False)
    for a, b in zip(served.off, on):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    recs = spans.records()
    # the first request since reset(): the served pipeline's was before it
    assert [s.name for s in spans.setup_records()] == ["mnc.first_request"]
    roots = [s for s in recs if s.name == "mnc.request"]
    assert len(roots) == len(served.inputs) and len({r.request for r in roots}) == len(roots)
    for root in roots:
        mine = [s for s in recs if s.request == root.request]
        counts = {}
        for s in mine:
            counts[s.name] = counts.get(s.name, 0) + 1
            if s is not root:
                assert s.parent is root
                assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert counts == PER_REQUEST
    assert len(recs) == sum(PER_REQUEST.values()) * len(roots)


def test_export_traces_the_same_graph_with_spans_on(served):
    from mnc_tpu_torch.models.mnc import _arch_constants
    from mnc_tpu_torch.pipeline.export import _CanvasProgram

    model = served.pipe.model
    _arch_constants(model.arch, model.device)
    x, info = served.inputs[0]
    codes = []
    for on in (False, True):
        spans.reset()
        spans.enable(on)
        with torch.no_grad():
            program = torch.export.export(_CanvasProgram(model, served.pipe.post, False),
                                          (x, info.float()), strict=False)
        spans.enable(False)
        assert spans.records() == []
        codes.append(program.graph_module.code)
    assert codes[0] == codes[1]
    assert "record_function" not in codes[1]


# --------------------------------------------------------------------------- #
# what the benchmark reads
# --------------------------------------------------------------------------- #


class FakeSpan:
    def __init__(self, name, start, end, ms=None):
        self.name, self.start_ns, self.end_ns, self.ms = name, start, end, ms

    def device_ms(self):
        return self.ms


def synthetic():
    """A window [0, 1000) with the device busy on [100, 300), [250, 400),
    [600, 700): idle [0, 100), [400, 600), [700, 1000).  Two requests; one
    span outside the window."""
    trace = Trace(0, 1000, [(100, 300, "k1"), (250, 400, "k2"), (600, 700, "k3"),
                            (1200, 1300, "late")], [])
    recs = [FakeSpan("mnc.request", 50, 500), FakeSpan("mnc.trunk", 60, 150),
            FakeSpan("mnc.propose", 150, 200, 0.25), FakeSpan("mnc.heads", 380, 450),
            FakeSpan("mnc.request", 500, 990), FakeSpan("mnc.trunk", 500, 520),
            FakeSpan("mnc.propose", 520, 560, 0.75), FakeSpan("mnc.heads", 560, 650),
            FakeSpan("mnc.heads", 680, 760),
            FakeSpan("mnc.request", 1100, 1400), FakeSpan("mnc.propose", 1100, 1200, 9.0)]
    return trace, recs


def test_idle_under_ranges_and_the_window():
    trace, recs = synthetic()
    assert len(program_spans.in_window(trace, recs)) == 9
    # idle [0, 100), [400, 600), [700, 1000); ranges overlapping each other
    assert program_spans.idle_under_ns(trace, [(50, 150), (80, 120), (450, 1200)]) == 50 + 150 + 300
    assert program_spans.idle_under_ns(trace, []) == 0
    assert program_spans.idle_under_ns(trace, [(0, 1000)]) == 100 + 200 + 300
    busy = Trace(0, 10, [(0, 10, "k")], [])
    assert program_spans.idle_under_ns(busy, [(0, 10)]) == 0


def test_gap_and_device_ms_on_known_overlaps():
    trace, recs = synthetic()
    # request: [50, 100) + [400, 500) | [500, 600) + [700, 990) = 50 + 100 + 100 + 290 ns
    assert program_spans.gap_ms(trace, recs, "mnc.request") == pytest.approx(540 / 1e6 / 2)
    # trunk: [60, 100) = 40; [500, 520) = 20
    assert program_spans.gap_ms(trace, recs, "mnc.trunk") == pytest.approx(60 / 1e6 / 2)
    # heads: [400, 450) = 50; [560, 600) = 40; [700, 760) = 60
    assert program_spans.gap_ms(trace, recs, "mnc.heads") == pytest.approx(150 / 1e6 / 2)
    assert program_spans.device_ms(trace, recs, "mnc.propose") == pytest.approx(0.5)
    assert program_spans.device_ms(trace, recs, "mnc.heads") is None  # host-timed only
    assert program_spans.gap_ms(trace, recs, "mnc.pack") is None
    empty = Trace(2000, 3000, [], [])
    assert program_spans.gap_ms(empty, recs, "mnc.request") is None


def _ctx(trace):
    return harness.LayerContext({}, {}, 4, {}, trace, 2, {})


def _setup_span(name, seconds):
    return spans.Span(name, None, None, 1_000, 1_000 + int(seconds * 1e9))


def test_the_seven_readers(monkeypatch):
    trace, recs = synthetic()
    monkeypatch.setattr(spans, "records", lambda: recs)
    monkeypatch.setattr(spans, "setup_records", lambda: [
        _setup_span("mnc.build", 2.5), _setup_span("mnc.first_request", 4.0),
        _setup_span("mnc.build", 9.0)])
    got = {name: reader(name)(_ctx(trace)) for name in READERS}
    assert got["propose_ms"] == pytest.approx(0.5) and got["pack_ms"] is None
    assert got["request_gap_ms"] == pytest.approx(270e-6)
    assert got["trunk_gap_ms"] == pytest.approx(30e-6)
    assert got["heads_gap_ms"] == pytest.approx(75e-6)
    assert (got["model_build_s"], got["first_request_s"]) == (2.5, 4.0)
    assert all(reader(name)(_ctx(None)) is None for name in READERS)  # no device trace


def test_readers_give_nothing_for_a_program_without_spans(monkeypatch):
    trace, _ = synthetic()
    monkeypatch.setitem(sys.modules, "mnc_tpu_torch.utils.spans", None)  # import fails
    assert all(reader(name)(_ctx(trace)) is None for name in READERS)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
def test_the_program_clock_is_the_device_trace_clock(monkeypatch):
    """In a traced window of ``vgg16_voc.serve_b4`` the program's spans are
    on the profiler's host clock, and they hold the device work of their
    request (copies and fills left out: the harness uploads a request's
    canvases before ``_run_batch``):

    - each profiler range ``mnc.request`` starts where the program's span does;
    - each kernel's launch call lies between its request's ``mnc.request``
      start and the next request's start (host clock against host clock);
    - each kernel lies there too on the device timeline, once that is
      shifted by the least that puts no kernel before its own launch call:
      the profiler converts the device's timestamps to the host clock afresh
      each time it starts, and on the H100 one profile's kernels have come
      out up to 0.3 ms before their launch calls (``PERF.md`` §3).  The harness
      synchronizes after each request, so a kernel outside is a clock fault.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import trace as trace_mod

    kept = []
    from_profiler = trace_mod.from_profiler

    def keep(prof, start_ns, end_ns):
        kept.append((prof, from_profiler(prof, start_ns, end_ns)))
        return kept[-1][1]
    monkeypatch.setattr(trace_mod, "from_profiler", keep)
    spans.reset()
    spans.enable(True)  # the profiler ranges too, which the first check reads
    result = harness.run("vgg16_voc.serve_b4", SEED, 5.0, True, device="cuda")
    assert result["correct"]
    (prof, device_only), (_, with_host) = kept
    recs = spans.records()

    mine = sorted(s.start_ns for s in program_spans.in_window(with_host, recs)
                  if s.name == "mnc.request")
    theirs = sorted(s for s, _, name, _ in with_host.host if name == "mnc.request")
    assert len(mine) == len(theirs) >= 1
    lags = [t - m for t, m in zip(theirs, mine)]
    print(f"profiler's mnc.request start - span start: {min(lags)}..{max(lags)} ns")
    assert all(abs(d) <= 100_000 for d in lags)

    starts = sorted(s.start_ns for s in program_spans.in_window(device_only, recs)
                    if s.name == "mnc.request")
    assert len(starts) >= 8
    ends = starts[1:] + [device_only.end_ns]
    launches, device = {}, []
    for ev in prof.profiler.kineto_results.events():
        kind, name = str(ev.device_type()), ev.name()
        if kind.endswith("CPU") and name.startswith("cu") and "Launch" in name:
            launches[ev.correlation_id()] = ev.start_ns()
        elif kind.endswith("CUDA") and not name.startswith(("Memcpy", "Memset", "mnc.")):
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name,
                           ev.correlation_id()))
    kernels = [(s, e, name, launches.get(c)) for s, e, name, c in device]
    assert len(kernels) > 100 * len(starts)

    def request_of(t):
        return bisect.bisect_right(starts, t) - 1

    launched = [(s, t, name) for s, _, name, t in kernels if t is not None]
    assert launched
    for _, t, name in launched:
        i = request_of(t)
        assert i >= 0 and t < ends[i], f"{name} launched outside any request"
    shift = max(0, max(t - s for s, t, _ in launched))
    outside = []
    for s, e, name, _ in kernels:
        i = request_of(s + shift)
        outside.append((starts[0] - s - shift if i < 0 else e + shift - ends[i], name))
    worst, name = max(outside)
    print(f"{len(kernels)} kernels of {len(starts)} requests, {len(launched)} matched to their "
          f"launch calls; the device timeline shifted by {shift} ns; the farthest outside its "
          f"request by {worst} ns")
    assert worst <= 0, name


@pytest.mark.cuda
def test_a_profile_holds_span_ranges_only_after_enable():
    """The harness's traces read every event of the profile: a span's
    range (which ``key_averages`` also shows as a device row over the span's
    kernels and gaps) must not be there unless ``enable`` asked for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    _, config, traffic = harness.resolve("vgg16_voc.serve_b4", harness.manifest())
    small("float32")(config, traffic)
    net, post = config["net"], config["post"]
    dev = torch.device("cuda")
    pipe = harness.build_system(net, post, weights.draw(net, SEED, dev, torch.float32), dev)
    pool = generator.make_pool(traffic, net["canvas"], SEED, dev)
    x, info = pool.canvases[0].to(dev), pool.im_info[0].to(dev)
    pipe.detect_canvas_batch_packed(x, info)
    torch.cuda.synchronize()
    for on in (False, True):
        spans.reset()
        spans.enable(on)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.detect_canvas_batch_packed(x, info)
            torch.cuda.synchronize()
        spans.enable(False)
        assert sorted(s.name for s in spans.records()) == sorted(
            n for n, k in PER_REQUEST.items() for _ in range(k))
        assert all(s.device_ms() > 0 for s in spans.records() if s.events is not None)
        kinds = {}
        for ev in prof.profiler.kineto_results.events():
            if ev.name().startswith("mnc."):
                kinds.setdefault(str(ev.device_type()).split(".")[-1], []).append(ev.name())
        print(f"enable({on}): span events by device type "
              f"{ {k: dict(collections.Counter(v)) for k, v in kinds.items()} }")
        if on:
            assert set(kinds.get("CPU", [])) == set(PER_REQUEST)
        else:
            assert kinds == {}
