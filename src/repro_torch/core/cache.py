"""Thread-safe LRU caches (paper §3.2).

The chunk fetcher uses two separate caches so prefetch traffic cannot evict
explicitly accessed chunks ("to avoid cache pollution", paper §3.2): a small
*access cache* (size 1 for plain sequential decompression) and a *prefetch
cache* sized at twice the parallelism. False-positive chunk results enter
the prefetch cache under a wrong offset key, are never requested, and age
out — that eviction path is what makes the whole architecture robust.

The class is written so that shared-resource variants can subclass it
(`service/cache_pool.py`): every mutation goes through a ``*_locked`` core
method that reports exactly what changed, public methods re-dispatch through
those cores under one lock acquisition, and the lock is re-entrant.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Tuple


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}

    def copy(self) -> "CacheStats":
        return CacheStats(**self.as_dict())

    def merge(self, *others: "CacheStats") -> "CacheStats":
        """New CacheStats summing ``self`` with ``others`` (for fleet-wide
        aggregation across many caches; does not mutate any operand)."""
        out = self.copy()
        for other in others:
            if isinstance(other, dict):
                other = CacheStats(**{k: int(other.get(k, 0)) for k in out.__dataclass_fields__})
            out.hits += other.hits
            out.misses += other.misses
            out.insertions += other.insertions
            out.evictions += other.evictions
        return out

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class LRUCache:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        # Re-entrant so subclasses can wrap a core op + bookkeeping in one
        # critical section without self-deadlocking.
        self._lock = threading.RLock()
        self.stats = CacheStats()

    # -- core mutations (hold the lock; report what changed) ---------------

    def _get_locked(
        self, key: Hashable, record_miss: bool = True
    ) -> Tuple[bool, Optional[Any]]:
        if key in self._data:
            self._data.move_to_end(key)
            self.stats.hits += 1
            return True, self._data[key]
        if record_miss:
            self.stats.misses += 1
        return False, None

    def _insert_locked(
        self, key: Hashable, value: Any
    ) -> Tuple[Optional[Any], List[Tuple[Hashable, Any]]]:
        """Returns (replaced_value_or_None, [(evicted_key, evicted_value)])."""
        if key in self._data:
            replaced = self._data[key]
            self._data.move_to_end(key)
            self._data[key] = value
            return replaced, []
        self._data[key] = value
        self.stats.insertions += 1
        evicted: List[Tuple[Hashable, Any]] = []
        while len(self._data) > self.capacity:
            evicted.append(self._data.popitem(last=False))
            self.stats.evictions += 1
        return None, evicted

    def _pop_locked(self, key: Hashable) -> Optional[Any]:
        return self._data.pop(key, None)

    # -- public interface ---------------------------------------------------

    def get(self, key: Hashable) -> Optional[Any]:
        return self.lookup(key)

    def lookup(self, key: Hashable, *, record_miss: bool = True) -> Optional[Any]:
        """get() that optionally skips miss accounting.

        One *logical* lookup that probes several caches in sequence (access
        then prefetch, `GzipChunkFetcher._cache_lookup`) must record exactly
        one hit or one miss fleet-wide; probing the first cache with
        ``record_miss=False`` lets the later cache own the miss.
        """
        with self._lock:
            _, val = self._get_locked(key, record_miss=record_miss)
            return val

    def peek(self, key: Hashable) -> Optional[Any]:
        """Get without touching LRU order or stats."""
        with self._lock:
            return self._data.get(key)

    def insert(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._insert_locked(key, value)

    def insert_hinted(
        self, key: Hashable, value: Any, *, recompute_cost: Optional[int] = None
    ) -> None:
        """insert() carrying an estimated cost (bytes of work) to recompute
        the value if evicted. The plain LRU ignores it; pool-backed caches
        (service/cache_pool.py) use it for cost-aware victim selection —
        cheap zlib-delegable chunks go before expensive marker-mode ones.
        """
        del recompute_cost
        self.insert(key, value)

    def pop(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            return self._pop_locked(key)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def snapshot(self) -> Dict[str, Any]:
        """Atomic view of (stats, occupancy) — one lock acquisition, so the
        counters and the length are mutually consistent even while fetcher
        threads keep hitting the cache."""
        with self._lock:
            return {
                "stats": self.stats.copy(),
                "len": len(self._data),
                "capacity": self.capacity,
            }
