"""Low-overhead span tracer with cross-thread and cross-wire propagation.

Design constraints (the pread hot path runs through here):

  * **~Zero cost disabled.** `span()` checks one module-level bool and
    returns a shared no-op context manager; `capture()` returns None.
    Nothing allocates, nothing takes a lock, no clock is read.
  * **Ring buffer, monotonic clocks.** Finished spans land in a bounded
    deque (oldest dropped); durations come from ``perf_counter`` and
    timestamps are wall-anchored once at import so a trace file lines up
    with log timestamps without ever going backwards.
  * **Propagation.** The current span context lives in a `ContextVar`, so
    it follows asyncio tasks for free. Thread hops (executor submit →
    worker, async bridge, engine dispatcher) carry it explicitly:
    ``ctx = capture()`` at submit, ``with attach(ctx):`` in the worker.
    The wire uses a W3C ``traceparent``-style header
    (``00-<trace32>-<span16>-01``): `current_traceparent()` on the client,
    `parse_traceparent()` + ``span(..., parent=ctx)`` on the server — one
    fleet read that crosses two gateways yields a single stitched trace.
  * **Histograms at span boundaries.** Every finished span observes its
    duration into the process histogram registry (`obs.hist`), so latency
    distributions accumulate whenever tracing is on. `timed()` is the
    always-on variant for service boundaries: it records the histogram
    even while tracing is disabled, and becomes a real span when enabled.

Span identity is (trace_id: 16 bytes hex, span_id: 8 bytes hex); a context
is the ``(trace_id, span_id)`` tuple. `dump_trace()` writes Chrome
trace-event JSON readable by chrome://tracing / Perfetto.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from time import perf_counter as _pc
from typing import Any, Dict, List, Optional, Tuple

from . import hist as _hist

SpanContext = Tuple[str, str]  # (trace_id, span_id)

#: Wall-clock anchor: span timestamps are ``_WALL0 + (perf_counter() -
#: _MONO0)`` — monotone within the process, comparable across processes to
#: within clock skew (good enough to line a trace up with server logs).
_WALL0 = time.time()
_MONO0 = time.perf_counter()

_DEFAULT_CAPACITY = 8192

_enabled = False
_lock = threading.Lock()
_spans: deque = deque(maxlen=_DEFAULT_CAPACITY)
_recorded_total = 0

_current: ContextVar[Optional[SpanContext]] = ContextVar("repro_obs_span", default=None)

#: Id scheme: one process-wide random 64-bit prefix (collision resistance
#: across processes) plus an atomic counter (uniqueness within the
#: process). ``os.urandom`` per span is a ~700 ns syscall — far too slow
#: for the pread hot path; ``next()`` on an ``itertools.count`` is a
#: GIL-atomic C call (~50 ns). The counter starts on a random 56-bit value
#: so span ids are never zero and never repeat for the process lifetime.
_TRACE_PREFIX = os.urandom(8).hex()
_id_counter = itertools.count(int.from_bytes(os.urandom(7), "big") + 1)

#: tid → thread name, filled lazily on first record from each thread:
#: ``threading.current_thread()`` costs ~300 ns, a dict probe ~40 ns.
_thread_names: Dict[int, str] = {}


def _wall(t_mono: float) -> float:
    return _WALL0 + (t_mono - _MONO0)


def _record(name, trace_id, span_id, parent_id, t0, dur, attrs) -> None:
    """Append one finished span (compact tuple; dicts are materialized at
    read time — the ring sees far more appends than reads).

    Lock-free on purpose: ``deque.append`` is a single GIL-atomic C call,
    and the total counter tolerates a (rare) lost increment under thread
    races — `tracing_stats` clamps ``dropped`` at 0, and exact accounting
    only matters to single-threaded tests. The lock guards the *read/clear*
    side (snapshot vs. resize), where consistency is worth its cost.
    """
    global _recorded_total
    tid = threading.get_ident()
    if tid not in _thread_names:
        _thread_names[tid] = threading.current_thread().name
    _spans.append((name, trace_id, span_id, parent_id, t0, dur, tid, attrs))
    _recorded_total += 1
    _hist.observe(name, dur)


def _materialize(rec) -> Dict[str, Any]:
    name, trace_id, span_id, parent_id, t0, dur, tid, attrs = rec
    return {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "ts": _wall(t0),
        "dur_s": dur,
        "thread": tid,
        "thread_name": _thread_names.get(tid, str(tid)),
        "attrs": attrs or {},
    }


# -- enable / disable --------------------------------------------------------


def enable_tracing(capacity: Optional[int] = None) -> None:
    """Turn the recorder on. ``capacity`` sizes the ring buffer; None means
    the default (8192), not "keep the current size" — so enable/disable
    cycles are deterministic regardless of what a previous caller chose."""
    global _enabled, _spans
    want = max(1, capacity if capacity is not None else _DEFAULT_CAPACITY)
    with _lock:
        if want != _spans.maxlen:
            _spans = deque(_spans, maxlen=want)
        _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


def reset_tracing() -> None:
    """Clear recorded spans and counters (tests/benchmarks)."""
    global _recorded_total
    with _lock:
        _spans.clear()
        _recorded_total = 0


def tracing_stats() -> Dict[str, Any]:
    with _lock:
        recorded = len(_spans)
        total = _recorded_total
        cap = _spans.maxlen or 0
    return {
        "enabled": _enabled,
        "recorded": recorded,
        "recorded_total": total,
        "dropped": max(0, total - recorded),
        "capacity": cap,
    }


# -- context -----------------------------------------------------------------


def current_context() -> Optional[SpanContext]:
    """The (trace_id, span_id) of the innermost live span, if any."""
    return _current.get()


def capture() -> Optional[SpanContext]:
    """Context to carry across a thread hop (None while disabled: a
    submit-side flag check is the only cost of instrumented executors)."""
    if not _enabled:
        return None
    return _current.get()


class _Attach:
    """Install a carried context as current for the worker-side block."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[SpanContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None:
            self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _current.reset(self._token)
        return False


def attach(ctx: Optional[SpanContext]) -> _Attach:
    return _Attach(ctx)


# -- traceparent header ------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"


def current_traceparent() -> Optional[str]:
    """``00-<trace_id>-<span_id>-01`` for the current context, else None."""
    ctx = _current.get()
    if ctx is None:
        return None
    return "00-%s-%s-01" % ctx


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent header into a SpanContext (None when absent or
    malformed — a bad header must never fail the request)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 3:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return (trace_id, span_id)


# -- spans -------------------------------------------------------------------


class Span:
    """A live span; records itself into the ring buffer on exit."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs", "_t0", "_token")

    def __init__(
        self,
        name: str,
        attrs: Optional[Dict[str, Any]],
        parent: Optional[SpanContext],
    ):
        if parent is None:
            parent = _current.get()
        self.span_id = sid = "%016x" % next(_id_counter)
        if parent is None:
            # Root: reuse the just-formatted span id as the trace-id suffix
            # (one %x format instead of two — this runs on the warm path).
            self.trace_id = _TRACE_PREFIX + sid
            self.parent_id = None
        else:
            self.trace_id = parent[0]
            self.parent_id = parent[1]
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._token = None

    @property
    def context(self) -> SpanContext:
        return (self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._token = _current.set((self.trace_id, self.span_id))
        self._t0 = _pc()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _pc()
        if self._token is not None:
            _current.reset(self._token)
        if exc_type is not None:
            self.set_attr("error", exc_type.__name__)
        # _record() inlined: this is the hottest exit in obs and the extra
        # frame showed up in the warm-pread overhead budget.
        global _recorded_total
        tid = threading.get_ident()
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
        dur = t1 - self._t0
        _spans.append(
            (self.name, self.trace_id, self.span_id, self.parent_id,
             self._t0, dur, tid, self.attrs)
        )
        _recorded_total += 1
        _hist.observe(self.name, dur)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    context = None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


def span(
    name: str,
    attrs: Optional[Dict[str, Any]] = None,
    parent: Optional[SpanContext] = None,
):
    """A span while tracing is enabled; a shared no-op otherwise."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs, parent)


class _Timed:
    """Histogram-only timer: the always-on fallback for `timed()`."""

    __slots__ = ("name", "_t0")
    trace_id = None
    span_id = None
    parent_id = None
    context = None

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        _hist.observe(self.name, time.perf_counter() - self._t0)
        return False


def record_span(
    name: str,
    t0: float,
    dur_s: float,
    attrs: Optional[Dict[str, Any]] = None,
    parent: Optional[SpanContext] = None,
) -> None:
    """Append an already-measured interval as a completed span.

    For hot paths that decide *after the fact* whether the interval is
    interesting (e.g. a cache lookup records only on miss): the caller pays
    one ``perf_counter()`` up front and only builds a span for the rare
    outcome, instead of allocating a live `Span` on every iteration. The
    recorded span parents under the current context (or ``parent``) like a
    live span would, but cannot itself have children — by the time it is
    recorded, the interval is over.
    """
    if not _enabled:
        return
    ctx = parent if parent is not None else _current.get()
    if ctx is None:
        trace_id = _TRACE_PREFIX + ("%016x" % next(_id_counter))
        parent_id = None
    else:
        trace_id, parent_id = ctx
    _record(name, trace_id, "%016x" % next(_id_counter), parent_id, t0, dur_s, attrs)


def timed(
    name: str,
    attrs: Optional[Dict[str, Any]] = None,
    parent: Optional[SpanContext] = None,
):
    """Always-on latency boundary: observes the duration histogram even
    while tracing is disabled, upgrades to a full span when enabled. Use at
    service boundaries (read_range, gateway request, bridge, executor) —
    not in per-chunk hot loops, which use `span()` and cost one flag check
    while disabled."""
    if _enabled:
        return Span(name, attrs, parent)
    return _Timed(name)


# -- recorded-span access ----------------------------------------------------


def recorded_spans() -> List[Dict[str, Any]]:
    """Snapshot of the ring buffer, oldest first."""
    with _lock:
        out = list(_spans)
    return [_materialize(r) for r in out]


def drain_spans() -> List[Dict[str, Any]]:
    """Snapshot and clear the ring buffer."""
    global _recorded_total
    with _lock:
        out = list(_spans)
        _spans.clear()
        _recorded_total = 0
    return [_materialize(r) for r in out]


def spans_for(trace_id: str) -> List[Dict[str, Any]]:
    """All recorded spans of one trace (the slow-request span tree)."""
    with _lock:
        out = [r for r in _spans if r[1] == trace_id]
    return [_materialize(r) for r in out]


def span_tree(trace_id: str) -> List[Dict[str, Any]]:
    """`spans_for` sorted by start time — readable as an indented tree."""
    return sorted(spans_for(trace_id), key=lambda s: s["ts"])


def dump_trace(path: Optional[str] = None, spans: Optional[List[Dict[str, Any]]] = None):
    """Chrome trace-event JSON for the recorded spans.

    Returns the trace dict; writes it to ``path`` when given. Load the file
    in chrome://tracing or https://ui.perfetto.dev — one row per thread,
    spans nested by duration, args carry the span/trace ids so a wire hop
    can be followed across two processes' dumps.
    """
    if spans is None:
        spans = recorded_spans()
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    seen_threads: Dict[int, str] = {}
    for s in spans:
        tid = s["thread"] or 0
        if tid not in seen_threads:
            seen_threads[tid] = s["thread_name"] or str(tid)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": seen_threads[tid]},
            })
        args = dict(s["attrs"])
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s["parent_id"]:
            args["parent_id"] = s["parent_id"]
        events.append({
            "ph": "X",
            "name": s["name"],
            "cat": "repro",
            "pid": pid,
            "tid": tid,
            "ts": s["ts"] * 1e6,
            "dur": s["dur_s"] * 1e6,
            "args": args,
        })
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
    return trace
