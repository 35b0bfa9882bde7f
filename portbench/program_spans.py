"""The program's own spans in a traced window, on the clock of
``torch.profiler``'s trace, and the per-layer numbers read from them.

The program records spans with its tracer (``repro_torch.obs.trace``),
off by default: one flag check a span. In a traced window
``ProgramTrace.start()`` clears the ring and turns the tracer on, and
``ProgramTrace.reduce(prof, w0_ns, w1_ns)``, after the profiler has
stopped, drains the ring, turns the tracer off and reduces the profiler's
trace with the program's spans beside the benchmark's own (``pb.*``):

* a span's stamps are ``perf_counter`` values; a pair of readings,
  ``time.time_ns()`` and ``time.perf_counter()`` taken together at the
  window's start, moves them onto the profiler's clock (``time_ns``);
* each idle gap of the device is labelled with the innermost span, the
  benchmark's or the program's, open on the driver's thread at the gap's
  middle (``"host"`` where none is): the gaps and their total are those of
  ``harness.reduce_trace``, only the labels are more specific;
* ``device_by_span``: each kernel's device seconds go to the innermost
  program span open on the driver's thread when it was launched. A kernel
  is matched to its launch (``cudaLaunchKernel`` and the like) by the
  profiler's correlation id. The launch is placed by its time alone: the
  profiler's thread ids are its own (the driver's is 1) and name the
  launching thread of no kernel the stage-2 engine launches, so a kernel
  of another thread goes to the driver's span of that moment.
  ``unmatched`` holds kernels whose launch the trace lacks, ``outside``
  those launched outside every program span.

The readers of the per-layer metrics take the reduction (``stage1_busy_pct``,
``crc_fold_pct``, ``optimizer_device_pct``, ``dispatch_ms``); each gives
None where the ring dropped a span or there is nothing to read.
"""

from __future__ import annotations

import heapq
import statistics
import threading
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

#: Spans the ring holds: far above a 40 s window's (a few thousand).
CAPACITY = 1 << 18

#: Host-side calls whose correlation id a device event carries.
LAUNCH_PREFIXES = ("cuda", "cu")


class Span(NamedTuple):
    """A program span on the profiler's clock (ns); ``thread`` is the
    recording thread's ``threading.get_ident()``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    span_id: str
    parent_id: Optional[str]


class ProgramTrace:
    """The program's tracer over one traced window (see the module's
    docstring). ``driver`` is the thread that called ``start()``."""

    def __init__(self):
        self.driver: Optional[int] = None
        self._anchor: Tuple[int, float] = (0, 0.0)

    def start(self) -> None:
        from repro_torch.obs import trace

        trace.disable_tracing()
        trace.reset_tracing()  # whatever set-up recorded
        self.driver = threading.get_ident()
        pc0 = time.perf_counter()
        ns = time.time_ns()
        pc1 = time.perf_counter()
        self._anchor = (ns, (pc0 + pc1) / 2)
        trace.enable_tracing(CAPACITY)

    def reduce(self, prof, w0_ns: int, w1_ns: int) -> Dict[str, Any]:
        """Drain the ring, turn the tracer off and reduce ``prof``'s trace
        of the window with the ring's spans on the profiler's clock."""
        from repro_torch.obs import trace

        dropped = trace.tracing_stats()["dropped"]
        raw = trace.drain_spans()
        trace.disable_tracing()
        ns0, pc0 = self._anchor
        # The ring gives each stamp as trace._wall(perf_counter); the same
        # map of the anchor's perf_counter reading undoes it.
        wall0 = trace._wall(pc0)
        spans = []
        for s in raw:
            start = ns0 + round((s["ts"] - wall0) * 1e9)
            spans.append(Span(s["name"], start, start + round(s["dur_s"] * 1e9), s["thread"],
                              s["span_id"], s["parent_id"]))
        return reduce(prof, w0_ns, w1_ns, spans, dropped, driver=self.driver)


def innermost(spans: List[Tuple[int, int, str]], times: List[int], default: str) -> List[str]:
    """For each time, the name of the shortest span ``(start, end, name)``
    with ``start <= time <= end`` (of equal ones the first listed), else
    ``default``: one sweep over the sorted times."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out = [default] * len(times)
    heap: List[Tuple[int, int, int, str]] = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and spans[order[j]][0] <= t:
            s, e, n = spans[order[j]]
            heapq.heappush(heap, (e - s, order[j], e, n))
            j += 1
        while heap and heap[0][2] < t:
            heapq.heappop(heap)  # ended: a longer one still open is below it
        if heap:
            out[q] = heap[0][3]
    return out


def reduce(prof, w0_ns: int, w1_ns: int, spans: List[Span], dropped: int, *,
           driver: Optional[int]) -> Dict[str, Any]:
    """``harness.reduce_trace``'s summary of a stopped profiler's trace
    (device work taken alike) with the idle gaps labelled by the program's
    spans on ``driver``'s thread too, plus ``device_by_span`` and the
    window's spans (``program_spans``, ``program_spans_dropped``)."""
    from torch.autograd import DeviceType

    device, pb, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if d > 0 and s + d > w0_ns and s < w1_ns and not e.is_user_annotation():
                device.append((max(s, w0_ns), min(s + d, w1_ns), e.name(), e.correlation_id()))
        elif e.name().startswith("pb."):
            pb.append((s, s + d, e.name()))
        elif e.name().startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = s

    by_name: Dict[str, float] = {}
    for s, e, n, _ in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    dev = sorted(device)
    busy, gaps, cur_s, cur_e = 0, [], None, w0_ns
    for s, e, _, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, w1_ns))

    window = [s for s in spans if s.end_ns > w0_ns and s.start_ns < w1_ns]
    driver_spans = [(s.start_ns, s.end_ns, s.name) for s in window if s.thread == driver]
    gaps = [(a, b) for a, b in gaps if b > a]
    idle: Dict[str, float] = {}
    for (a, b), label in zip(gaps, innermost(pb + driver_spans,
                                             [(a + b) // 2 for a, b in gaps], "host")):
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9

    by_span: Dict[str, float] = {}
    launched = [(s, e, launches[c]) for s, e, _, c in device if c in launches]
    for (s, e, _), key in zip(launched, innermost(driver_spans, [at for _, _, at in launched],
                                                  "outside")):
        by_span[key] = by_span.get(key, 0.0) + (e - s) * 1e-9
    unmatched = sum(e - s for s, e, _, c in device if c not in launches)
    if unmatched:
        by_span["unmatched"] = unmatched * 1e-9

    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy * 1e-9, "window_s": (w1_ns - w0_ns) * 1e-9, "kernels": by_name,
            "device_ops": top(by_name), "idle_gaps": top(idle), "device_by_span": by_span,
            "program_spans": window, "program_spans_dropped": dropped,
            "w0_ns": w0_ns, "w1_ns": w1_ns}


# -- interval arithmetic ---------------------------------------------------------


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The intervals merged into disjoint ones, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(interval: Tuple[int, int], holes: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """What of ``interval`` the holes leave uncovered."""
    s, e = interval
    out = []
    for hs, he in union(holes):
        if he <= s or hs >= e:
            continue
        if hs > s:
            out.append((s, hs))
        s = max(s, he)
    if s < e:
        out.append((s, e))
    return out


def _clip(intervals, w0: int, w1: int) -> List[Tuple[int, int]]:
    return [(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1]


# -- the metrics' arithmetic -------------------------------------------------------


def _spans(t: Optional[Dict[str, Any]]) -> Optional[List[Span]]:
    """The window's program spans, or None where there are none to trust."""
    if t is None or "program_spans" not in t or t["program_spans_dropped"]:
        return None
    return t["program_spans"]


def stage1_busy_pct(t) -> Optional[float]:
    """100 x the union over all threads of the self time of ``fetcher.task``
    spans (each minus its ``engine.batch_wait`` children) inside the
    window, over the window."""
    spans = _spans(t)
    if spans is None:
        return None
    tasks = [s for s in spans if s.name == "fetcher.task"]
    if not tasks:
        return None
    waits: Dict[str, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.name == "engine.batch_wait" and s.parent_id is not None:
            waits.setdefault(s.parent_id, []).append((s.start_ns, s.end_ns))
    own = [piece for task in tasks
           for piece in minus((task.start_ns, task.end_ns), waits.get(task.span_id, []))]
    busy = sum(e - s for s, e in union(_clip(own, t["w0_ns"], t["w1_ns"])))
    return 100.0 * busy / (t["w1_ns"] - t["w0_ns"])


def crc_fold_pct(t) -> Optional[float]:
    """100 x the seconds of ``engine.crc_fold`` spans inside the window
    over the window (the engine folds on its one dispatcher thread)."""
    spans = _spans(t)
    if spans is None:
        return None
    folds = [(s.start_ns, s.end_ns) for s in spans if s.name == "engine.crc_fold"]
    if not folds:
        return None
    inside = sum(e - s for s, e in _clip(folds, t["w0_ns"], t["w1_ns"]))
    return 100.0 * inside / (t["w1_ns"] - t["w0_ns"])


def optimizer_device_pct(t) -> Optional[float]:
    """100 x the device seconds of kernels launched inside ``train.optimizer``
    over the device's busy seconds in the window."""
    if _spans(t) is None or t["busy_s"] <= 0 or "train.optimizer" not in t["device_by_span"]:
        return None
    return 100.0 * t["device_by_span"]["train.optimizer"] / t["busy_s"]


def dispatch_ms(t, name: str = "serve.decode_step") -> Optional[float]:
    """The median duration (ms) of the window's ``name`` spans: the host's
    enqueue of one step, under the profiler."""
    spans = _spans(t)
    if spans is None:
        return None
    durs = [(s.end_ns - s.start_ns) * 1e-6 for s in spans
            if s.name == name and s.start_ns >= t["w0_ns"] and s.end_ns <= t["w1_ns"]]
    return statistics.median(durs) if durs else None
