"""``portbench.program_spans`` on synthetic events (the idle gaps'
labels, ``device_by_span``, the metrics' arithmetic), its clock against
``torch.profiler``'s on the host, and each driver's small traced run on the
host with the program's tracer on over the window."""

import threading
import time
from types import SimpleNamespace

import pytest

from portbench import harness, program_spans
from portbench.program_spans import Span

ME = threading.get_ident()
OTHER = ME + 1


class FakeEvent:
    """What the reductions read of one of the profiler's events."""

    def __init__(self, name, start, dur, *, device=False, corr=0, tid=1, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._corr, self._tid, self._annotation = device, corr, tid, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def kernel(start, end, corr=0, name="k"):
    return FakeEvent(name, start, end - start, device=True, corr=corr)


EVENTS = [FakeEvent("pb.read", 0, 1000, tid=7), kernel(100, 200, 1), kernel(150, 300, 2),
          kernel(500, 600, 3, "other"), FakeEvent("pb.read", 0, 1000, device=True,
                                                   annotation=True)]


def span(name, start, end, thread=ME, span_id="", parent=None):
    return Span(name, start, end, thread, span_id or "%s@%d" % (name, start), parent)


def reduce(events, spans=(), dropped=0, w=(0, 1000)):
    return program_spans.reduce(fake_prof(events), *w, list(spans), dropped, driver=ME)


def test_without_program_spans_the_reduction_is_the_harness_own():
    want = harness.reduce_trace(fake_prof(EVENTS), 0, 1000)
    got = reduce(EVENTS)
    for key in ("busy_s", "window_s", "kernels", "device_ops", "idle_gaps"):
        assert got[key] == want[key], key
    assert got["idle_gaps"] == [["pb.read", pytest.approx(7e-7)]]


def test_gaps_take_the_innermost_span_on_the_driver_thread():
    spans = [span("reader.frontier_wait", 0, 450), span("reader.chunk_wait", 310, 440),
             # another thread's span never labels a gap
             span("fetcher.task", 700, 900, thread=OTHER)]
    got = reduce(EVENTS, spans)
    gaps = dict((k, v) for k, v in got["idle_gaps"])
    # gaps [0, 100), [300, 500) and [600, 1000): middles 50, 400 and 800
    assert gaps == pytest.approx({"reader.frontier_wait": 1e-7, "reader.chunk_wait": 2e-7,
                                  "pb.read": 4e-7})
    assert sum(gaps.values()) == pytest.approx(got["window_s"] - got["busy_s"])
    assert got["busy_s"] == pytest.approx(harness.reduce_trace(fake_prof(EVENTS), 0,
                                                               1000)["busy_s"])


def test_a_gap_outside_every_span_is_the_host():
    got = reduce([kernel(100, 200, 1)])
    assert got["idle_gaps"] == [["host", pytest.approx(9e-7)]]


def test_device_seconds_go_to_the_span_open_at_launch():
    """By the launch's time, on the driver's thread: the profiler's thread
    ids are its own, whatever thread launched."""
    events = [
        FakeEvent("pb.step", 0, 1000, tid=1),
        FakeEvent("cudaLaunchKernel", 120, 5, corr=1, tid=1),
        kernel(300, 340, 1),  # runs after its span ended: the launch decides
        FakeEvent("cuLaunchKernel", 150, 5, corr=2, tid=3),  # another thread of the profiler's
        kernel(340, 400, 2),
        FakeEvent("cudaLaunchKernel", 520, 5, corr=3, tid=1),
        kernel(600, 610, 3),
        kernel(700, 705, 4),  # no launch in the trace
        FakeEvent("cudaMemcpyAsync", 950, 5, corr=5, tid=1),  # outside every program span
        kernel(960, 970, 5),
        FakeEvent("aten::mul", 100, 5, corr=4, tid=1),  # an operator, not a launch
    ]
    spans = [span("train.step_like", 0, 900), span("train.optimizer", 100, 200),
             span("train.backward", 500, 540),
             # another thread's span never takes a kernel
             span("engine.crc_fold", 100, 200, thread=OTHER)]
    got = reduce(events, spans)
    assert got["device_by_span"] == pytest.approx({
        "train.optimizer": 100e-9, "train.backward": 10e-9, "unmatched": 5e-9,
        "outside": 10e-9})
    assert sum(got["device_by_span"].values()) == pytest.approx(sum(got["kernels"].values()))


def test_innermost_is_the_shortest_open_span():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (40, 60, "d"), (20, 30, "c2")]
    times = [5, 25, 45, 55, 70, 100, 101, 30, 10]
    assert program_spans.innermost(spans, times, "-") == \
        ["a", "c", "d", "d", "a", "a", "-", "c", "b"]


def summary(spans, dropped=0, w=(0, 1000), **extra):
    return dict({"program_spans": spans, "program_spans_dropped": dropped, "w0_ns": w[0],
                 "w1_ns": w[1]}, **extra)


def test_stage1_busy_is_the_union_of_self_time():
    t1 = span("fetcher.task", 0, 1000, span_id="a")
    t2 = span("fetcher.task", 300, 500, thread=OTHER, span_id="b")
    spans = [t1, t2,
             span("engine.batch_wait", 200, 400, parent="a"),
             span("engine.batch_wait", 600, 700, parent="a"),
             span("engine.batch_wait", 350, 450, thread=OTHER, parent="b"),
             span("engine.batch_wait", 800, 900, parent="elsewhere")]
    # self time: [0, 200) [400, 600) [700, 1000) and [300, 350) [450, 500)
    assert program_spans.stage1_busy_pct(summary(spans, w=(0, 2000))) == pytest.approx(37.5)
    assert program_spans.stage1_busy_pct(summary(spans, w=(100, 1000))) == \
        pytest.approx(100 * 650 / 900)


def test_interval_helpers():
    assert program_spans.union([(5, 9), (0, 2), (1, 3), (9, 9), (8, 12)]) == [(0, 3), (5, 12)]
    assert program_spans.minus((0, 10), [(2, 3), (2, 4), (8, 20)]) == [(0, 2), (4, 8)]
    assert program_spans.minus((0, 10), [(-5, 15)]) == []


def test_fold_dispatch_and_optimizer_shares():
    folds = [span("engine.crc_fold", 0, 100), span("engine.crc_fold", 900, 1100),
             span("reader.verify", 0, 1000)]
    assert program_spans.crc_fold_pct(summary(folds)) == pytest.approx(20.0)
    steps = [span("serve.decode_step", a, a + d * 1_000_000)
             for a, d in ((0, 1), (10_000_000, 3), (20_000_000, 2), (990_000_000, 50))]
    assert program_spans.dispatch_ms(summary(steps, w=(0, 1_000_000_000))) == pytest.approx(2.0)
    t = summary([], busy_s=2.0, device_by_span={"train.optimizer": 0.5, "outside": 1.5})
    assert program_spans.optimizer_device_pct(t) == pytest.approx(25.0)


def test_nothing_to_read_or_a_dropped_span_gives_none():
    spans = [span("fetcher.task", 0, 10), span("engine.crc_fold", 0, 10),
             span("serve.decode_step", 0, 10)]
    for read in (program_spans.stage1_busy_pct, program_spans.crc_fold_pct,
                 program_spans.dispatch_ms):
        assert read(summary(spans)) is not None
        assert read(summary(spans, dropped=1)) is None
        assert read(summary([])) is None
        assert read(None) is None
        assert read({"busy_s": 1.0}) is None  # an untraced program: no spans at all
    t = summary([], busy_s=1.0, device_by_span={"train.optimizer": 0.5})
    assert program_spans.optimizer_device_pct(dict(t, program_spans_dropped=2)) is None
    assert program_spans.optimizer_device_pct(dict(t, device_by_span={})) is None


def clock_offset_ns(n: int = 20):
    """The program's span starts against the profiler's, both around the
    same sleeps: (median of program - profiler with the program's span
    inside the ``record_function``, the same with it outside, the trace's
    spans). Either median holds the cost of entering the inner one; their
    mean cancels it, and is the offset of the two clocks."""
    import statistics

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import trace

    pt = program_spans.ProgramTrace()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):  # the first sets the profiler up
                pass
            pt.start()
            w0 = time.time_ns()
            for i in range(2 * n):
                if i % 2:
                    with trace.span("clock.probe"), record_function("pb.clock"):
                        time.sleep(0.002)
                else:
                    with record_function("pb.clock"), trace.span("clock.probe"):
                        time.sleep(0.002)
                time.sleep(0.001)
            w1 = time.time_ns()
        t = pt.reduce(prof, w0, w1)
    finally:
        trace.disable_tracing()
        trace.reset_tracing()
    probes = sorted(s.start_ns for s in t["program_spans"] if s.name == "clock.probe")
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "pb.clock")
    assert len(probes) == len(starts) == 2 * n
    d = [a - b for a, b in zip(probes, starts)]
    return statistics.median(d[0::2]), statistics.median(d[1::2]), t, pt


def test_program_spans_land_on_the_profiler_clock():
    """A ``record_function`` and a program span over the same interval:
    after the conversion their starts agree within 100 us."""
    from repro_torch.obs import trace

    inside, outside, t, pt = clock_offset_ns()
    assert not trace.tracing_enabled()
    assert abs(inside + outside) / 2 < 100_000
    assert inside >= 0 >= outside  # the inner one starts second
    assert {s.thread for s in t["program_spans"]} == {pt.driver} == {threading.get_ident()}


# -- each driver's small traced run on the host, the program's tracer on -----------


@pytest.fixture
def wired(monkeypatch):
    """The harness's traced window with the program's tracer on over it."""
    start, finish = harness.Run.start_window, harness.Run.finish_trace

    def start_window(self):
        start(self)
        if self.trace:
            self.program = program_spans.ProgramTrace()
            self.program.start()

    def finish_trace(self):
        prof = self._prof
        finish(self)
        if prof is not None:
            self.trace_summary = self.program.reduce(prof, self._w0_ns, self._w1_ns)

    monkeypatch.setattr(harness.Run, "start_window", start_window)
    monkeypatch.setattr(harness.Run, "finish_trace", finish_trace)


def traced_small(cell: str):
    m = harness.Manifest()
    c = m.cell(cell)
    tr = m.traffic(c["traffic"])
    cfg, tr = harness.driver(tr["driver"]).small(m.config(c["config"]), tr)
    return harness.run_cell(m, cell, seed=2 ** 31 + 26, seconds=1.0, trace=True, device="cpu",
                            t_start=time.monotonic(), config=cfg, traffic=tr)


def _names(run):
    return {s.name for s in run.trace_summary["program_spans"]}


def test_read_small_traced_yields_stage1_and_fold(wired):
    run = traced_small("read.b64-gzip")
    assert run.correct, run.checks
    t = run.trace_summary
    assert t["program_spans_dropped"] == 0
    assert {"fetcher.task", "reader.chunk_wait", "reader.verify", "engine.crc_fold"} <= _names(run)
    assert 0 < program_spans.stage1_busy_pct(t) <= 100
    assert 0 < program_spans.crc_fold_pct(t) < 100
    assert sum(v for _, v in t["idle_gaps"]) == pytest.approx(t["window_s"] - t["busy_s"])


def test_train_small_traced_records_the_step_phases(wired):
    run = traced_small("train.granite-3-2b")
    assert run.correct, run.checks
    assert {"train.forward", "train.backward", "train.optimizer"} <= _names(run)
    # the device's share needs device work: none on the host
    assert program_spans.optimizer_device_pct(run.trace_summary) is None


def test_decode_small_traced_yields_dispatch(wired):
    run = traced_small("decode.granite-3-2b")
    assert run.correct, run.checks
    steps = [s for s in run.trace_summary["program_spans"] if s.name == "serve.decode_step"]
    assert steps and 0 < program_spans.dispatch_ms(run.trace_summary) < 1e3 * run.window_s


def test_untraced_runs_leave_the_tracer_off(wired):
    from repro_torch.obs import trace

    m = harness.Manifest()
    c = m.cell("decode.granite-3-2b")
    tr = m.traffic(c["traffic"])
    cfg, tr = harness.driver(tr["driver"]).small(m.config(c["config"]), tr)
    run = harness.run_cell(m, "decode.granite-3-2b", seed=7, seconds=0.5, trace=False,
                           device="cpu", t_start=time.monotonic(), config=cfg, traffic=tr)
    assert run.trace_summary is None and not trace.tracing_enabled()
    assert trace.tracing_stats()["recorded_total"] == 0
