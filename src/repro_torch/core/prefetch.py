"""Prefetching strategies (paper §3.2).

The default is the paper's ad-hoc strategy, "comparable to an exponentially
incremented adaptive asynchronous multi-stream prefetcher" (AMP, Gill &
Bathen FAST'07): it operates on *chunk indexes*, returns the full prefetch
degree on the first access of a stream so cold-start decompression is fully
parallel, tracks multiple concurrent sequential streams (the ratarmount
use-case: several files of one TAR read at once), and ramps the degree
exponentially as a stream proves itself. It deliberately does not remember
what it already prefetched — the fetcher filters cached/in-flight chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


class PrefetchStrategy:
    def on_access(self, index: int) -> List[int]:
        raise NotImplementedError


class NoPrefetch(PrefetchStrategy):
    def on_access(self, index: int) -> List[int]:
        return []


@dataclass
class _Stream:
    last_index: int
    hits: int


class AdaptivePrefetchStrategy(PrefetchStrategy):
    """Exponential, adaptive, multi-stream (paper §3.2 default)."""

    def __init__(self, degree: int, *, max_streams: int = 16, cold_start_full: bool = True):
        if degree < 0:
            raise ValueError("degree must be >= 0")
        self.degree = degree
        self.max_streams = max_streams
        self.cold_start_full = cold_start_full
        self._streams: Dict[int, _Stream] = {}  # keyed by stream id (insertion order)
        self._next_stream_id = 0

    def _find_stream(self, index: int):
        for sid, s in self._streams.items():
            # Tolerate small gaps/out-of-order completion within a stream.
            if 0 <= index - s.last_index <= 2:
                return sid, s
        return None, None

    def on_access(self, index: int) -> List[int]:
        if self.degree == 0:
            return []
        sid, stream = self._find_stream(index)
        if stream is None:
            # New stream: prefetch the full degree immediately so the thread
            # pool saturates on first access (paper: "returns the full degree
            # of prefetch for the initial access").
            if len(self._streams) >= self.max_streams:
                oldest = next(iter(self._streams))
                del self._streams[oldest]
            self._streams[self._next_stream_id] = _Stream(index, 1)
            self._next_stream_id += 1
            width = self.degree if self.cold_start_full else 2
        else:
            stream.hits += 1
            stream.last_index = max(stream.last_index, index)
            # Exponential ramp: 2, 4, 8, ... capped at the full degree.
            width = min(self.degree, 1 << min(stream.hits, 16))
        return [index + 1 + k for k in range(width)]


class BackwardPrefetchStrategy(PrefetchStrategy):
    """Prefetch behind the access point (reverse sequential scans)."""

    def __init__(self, degree: int):
        self.degree = degree

    def on_access(self, index: int) -> List[int]:
        return [index - 1 - k for k in range(self.degree) if index - 1 - k >= 0]
