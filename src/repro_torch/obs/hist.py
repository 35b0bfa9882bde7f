"""Fixed log-bucket latency histograms: lock-cheap, mergeable, Prom-ready.

Bucket scheme: powers of two in **microseconds**. Bucket *i* (0-based)
counts observations with ``value <= 2^i µs`` (and above the previous
bound); the final bucket is the +Inf overflow. 27 finite bounds span 1 µs
to ~67 s — a cache-hit pread and a cold remote scan land in the same
scheme, with ~2x relative error, and every histogram in the fleet shares
the bounds so snapshots merge by plain vector addition.

``observe`` is a single GIL-atomic ``deque.append`` of the raw float;
bucketization is deferred to snapshot time. That asymmetry is deliberate:
the hot path runs *between* megabyte memcpys, so its true cost is cache
misses, not instructions — an append touches two objects (the histogram
and its deque) where bucketize-under-lock touches dozens (lock, counts
list, boxed ints), and each cold line is ~100-300 ns on a virtualized
host. Readers (`snapshot`, `merge`) drain the pending deque into the
bucket vector under the lock; a reader racing a writer can miss an
in-flight append, which the next snapshot picks up — counts are still
monotone, which is all scrapers assume. Percentiles are read from the
cumulative vector at snapshot time: the reported pXX is the *upper bound*
of the bucket containing that quantile (conservative: the true latency is
≤ the reported number).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

#: Finite bucket upper bounds, in microseconds: 1µs, 2µs, 4µs ... 2^26µs.
_FINITE_BUCKETS = 27
BUCKET_BOUNDS_US: List[int] = [1 << i for i in range(_FINITE_BUCKETS)]
_NBUCKETS = _FINITE_BUCKETS + 1  # + overflow (+Inf)


def bucket_index(seconds: float) -> int:
    """Index of the bucket whose upper bound first covers ``seconds``."""
    us = seconds * 1e6
    if us <= 1.0:
        return 0
    u = int(us)
    if u < us:
        u += 1  # ceil: the bound must be >= the value
    idx = (u - 1).bit_length()
    return idx if idx < _NBUCKETS else _NBUCKETS - 1


class LogHistogram:
    """One latency distribution; thread-safe; merge by vector addition."""

    __slots__ = ("_lock", "_counts", "_sum", "_count", "_pending")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * _NBUCKETS
        self._sum = 0.0
        self._count = 0
        self._pending: deque = deque()

    def observe(self, seconds: float) -> None:
        # Hot path: one GIL-atomic append, no lock, no arithmetic. The
        # bucketization happens in `_drain_locked` when someone reads.
        self._pending.append(seconds)

    def _drain_locked(self) -> None:
        """Fold pending observations into the bucket vector (lock held).

        `popleft` until empty rather than swapping the deque out: an append
        racing the drain either lands before the final popleft (folded now)
        or after (folded by the next reader) — never lost.
        """
        pending = self._pending
        while True:
            try:
                seconds = pending.popleft()
            except IndexError:
                break
            if seconds < 0.0:
                seconds = 0.0
            us = seconds * 1e6
            if us <= 1.0:
                idx = 0
            else:
                u = int(us)
                if u < us:
                    u += 1
                idx = (u - 1).bit_length()
                if idx >= _NBUCKETS:
                    idx = _NBUCKETS - 1
            self._counts[idx] += 1
            self._sum += seconds
            self._count += 1

    def merge(self, other: "LogHistogram") -> None:
        with other._lock:
            other._drain_locked()
            counts = list(other._counts)
            total, s = other._count, other._sum
        with self._lock:
            self._drain_locked()
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += total
            self._sum += s

    def _percentile_locked(self, counts: List[int], total: int, q: float) -> float:
        """Upper bound (seconds) of the bucket holding quantile ``q``."""
        if total <= 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                if i < _FINITE_BUCKETS:
                    return BUCKET_BOUNDS_US[i] / 1e6
                # Overflow bucket: no finite bound; report twice the last
                # finite bound as a sentinel ("slower than the scheme").
                return (BUCKET_BOUNDS_US[-1] * 2) / 1e6
        return (BUCKET_BOUNDS_US[-1] * 2) / 1e6

    def snapshot(self) -> Dict[str, Any]:
        """Plain-JSON summary: count/sum, p50/p90/p99, cumulative buckets.

        ``buckets`` is a list of ``[le_seconds, cumulative_count]`` pairs
        over the finite bounds (the +Inf cumulative equals ``count``) —
        exactly the series Prometheus exposition needs. Empty buckets are
        elided to keep snapshots small; cumulative counts make that
        lossless.
        """
        with self._lock:
            self._drain_locked()
            counts = list(self._counts)
            total = self._count
            s = self._sum
        buckets: List[List[float]] = []
        cum = 0
        prev = 0
        for i in range(_FINITE_BUCKETS):
            cum += counts[i]
            if cum != prev:
                buckets.append([BUCKET_BOUNDS_US[i] / 1e6, cum])
                prev = cum
        return {
            "count": total,
            "sum_s": s,
            "p50_s": self._percentile_locked(counts, total, 0.50),
            "p90_s": self._percentile_locked(counts, total, 0.90),
            "p99_s": self._percentile_locked(counts, total, 0.99),
            "buckets": buckets,
        }


class HistogramRegistry:
    """Name → LogHistogram map; creation is locked, observation is not."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, LogHistogram] = {}

    def get(self, name: str) -> LogHistogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, LogHistogram())
        return h

    def observe(self, name: str, seconds: float) -> None:
        self.get(name).observe(seconds)

    def names(self) -> List[str]:
        if self is _REGISTRY:
            _flush_pending()
        with self._lock:
            return sorted(self._hists)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        if self is _REGISTRY:
            _flush_pending()
        with self._lock:
            items = list(self._hists.items())
        return {name: h.snapshot() for name, h in sorted(items)}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


#: Process-wide registry: spans and the always-on `timed()` boundaries all
#: observe here; `ArchiveServer.metrics()` snapshots it.
_REGISTRY = HistogramRegistry()

#: Module-wide pending (name, seconds) observations. `observe` appends here
#: — one GIL-atomic deque touch, no registry dict probe — and readers fold
#: the backlog into per-name histograms via `_flush_pending` before every
#: snapshot. Same monotone-counts contract as LogHistogram's own pending
#: deque, one level up.
_PENDING: deque = deque()


def registry() -> HistogramRegistry:
    return _REGISTRY


def observe(name: str, seconds: float) -> None:
    _PENDING.append((name, seconds))


def _flush_pending() -> None:
    pending = _PENDING
    get = _REGISTRY.get
    while True:
        try:
            name, seconds = pending.popleft()
        except IndexError:
            break
        get(name)._pending.append(seconds)


def histogram_snapshots() -> Dict[str, Dict[str, Any]]:
    _flush_pending()
    return _REGISTRY.snapshot()


def reset_histograms() -> None:
    _PENDING.clear()
    _REGISTRY.reset()


def merge_snapshots(
    a: Mapping[str, Any], b: Mapping[str, Any]
) -> Dict[str, Any]:
    """Merge two ``LogHistogram.snapshot()`` dicts (cross-process rollup).

    Percentiles are recomputed from the merged cumulative vectors, so the
    result is exactly what one histogram fed both streams would report.
    """
    def expand(snap: Mapping[str, Any]) -> List[int]:
        counts = [0] * _NBUCKETS
        cum_prev = 0
        bounds = {b: i for i, b in enumerate(BUCKET_BOUNDS_US)}
        for le_s, cum in snap.get("buckets", []):
            idx = bounds.get(int(round(le_s * 1e6)))
            if idx is None:
                continue
            counts[idx] += int(cum) - cum_prev
            cum_prev = int(cum)
        counts[_NBUCKETS - 1] += int(snap.get("count", 0)) - cum_prev
        return counts

    merged = LogHistogram()
    for snap in (a, b):
        counts = expand(snap)
        with merged._lock:
            for i, c in enumerate(counts):
                merged._counts[i] += c
            merged._count += int(snap.get("count", 0))
            merged._sum += float(snap.get("sum_s", 0.0))
    return merged.snapshot()
