"""CachePool — one memory budget shared by a fleet of readers.

`core/cache.py` gives every reader two private caches (access + prefetch,
paper §3.2). That is the right shape for one reader over one file; a service
multiplexing dozens of `ParallelGzipReader`s cannot let each of them size its
caches independently — worst-case memory is the *sum* of per-reader maxima.

The pool lifts the paper's two-tier split fleet-wide:

  * one **byte** budget, split into an *access tier* and a *prefetch tier*
    with separate sub-budgets — prefetch churn from any reader can never
    evict any reader's explicitly-accessed chunks (the paper's pollution
    argument, now across files and tenants);
  * **cost-aware LRU** within each tier: candidates come from the LRU end,
    but within a small recency window the victim is the entry with the
    lowest *recompute cost per byte* — a zlib-delegable indexed chunk
    (re-decodable >2x faster than two-stage, paper §1.3) goes before a
    marker-mode first-pass chunk of similar age. Inserters declare the cost
    via ``insert_hinted``; unhinted entries default to cost == size, which
    degrades to plain global LRU. Aging bounds the bias: an entry passed
    over ``EVICTION_WINDOW`` times without a hit is evicted regardless of
    cost, so cold expensive entries cannot pin the tier;
  * per-tenant accounting (bytes held, insertions, evictions suffered/caused,
    cumulative recompute cost of evicted entries) plus soft isolation with
    **weighted shares**: a tenant holding more than
    ``max_tenant_fraction * weight(tenant)`` of a tier evicts its *own*
    entries first, so one hot client cannot monopolize the pool, and
    operators can grant paying tenants a larger slice
    (``set_tenant_weight``).

Member caches are `PooledCache` — drop-in `LRUCache` subclasses, so the chunk
fetcher uses them unchanged via its injectable-cache hooks.

Lock ordering: a member cache always releases its own lock before calling
into the pool, and the pool releases its lock before touching a member cache
(victim eviction collects keys under the pool lock, then pops outside it).
Budget overshoot during the gap is transient and bounded by one entry.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Tuple

from ..core.cache import CacheStats, LRUCache

ACCESS = "access"
PREFETCH = "prefetch"

#: How many LRU-end entries compete per victim selection. Small: recency
#: stays the primary signal, cost only breaks near-ties — a hot expensive
#: entry is never outlived by a cold cheap one outside the window.
EVICTION_WINDOW = 8


def default_size_of(value: Any) -> int:
    """Approximate resident bytes of a cached value.

    Cached values are numpy arrays (indexed chunks), DecodeResult objects
    (first-pass chunks, dominated by their ``data`` array), or bytes.
    """
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    data = getattr(value, "data", None)
    if data is not None and hasattr(data, "nbytes"):
        return int(data.nbytes) + 256  # DecodeResult bookkeeping overhead
    try:
        return len(value)
    except TypeError:
        return 1024


@dataclass
class TenantStats:
    bytes_held: int = 0
    insertions: int = 0
    hits: int = 0
    misses: int = 0
    evictions_suffered: int = 0  # this tenant's entries evicted
    evictions_caused: int = 0  # evictions triggered by this tenant's inserts
    eviction_cost_suffered: int = 0  # recompute cost of this tenant's victims
    eviction_cost_caused: int = 0  # recompute cost this tenant's inserts evicted

    def as_dict(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}


@dataclass
class _Entry:
    cache: Any  # PooledCache
    size: int
    cost: int  # estimated bytes-of-work to recompute the value if evicted
    skips: int = 0  # times passed over for a cheaper, younger victim


@dataclass
class _Tier:
    budget: int
    held: int = 0
    # (cache_id, key) -> _Entry; order = LRU .. MRU
    entries: "OrderedDict[Tuple[int, Hashable], _Entry]" = field(
        default_factory=OrderedDict
    )
    evictions: int = 0
    evicted_bytes: int = 0
    evicted_cost: int = 0


class PooledCache(LRUCache):
    """LRUCache whose contents are charged against a shared CachePool.

    Keeps an (optional) per-cache entry capacity on top of the pool's byte
    budget — the fetcher still relies on a size-1 access cache meaning
    "current chunk only".
    """

    def __init__(self, pool: "CachePool", tier: str, tenant: str, capacity: Optional[int]):
        super().__init__(capacity if capacity is not None else 1 << 30)
        self._pool = pool
        self._tier = tier
        self.tenant = tenant
        self._cache_id = pool._next_cache_id()
        # Flipped under the pool lock by _deregister: inserts racing a
        # release (an in-flight decompression task finishing after its
        # reader closed — possible now that reads don't hold the entry
        # lock) must not re-charge the ledger of a deregistered cache.
        self._pool_registered = True

    # Mutations run the base core under the cache lock, then report to the
    # pool after releasing it (see lock-ordering note in the module doc).

    def get(self, key: Hashable) -> Optional[Any]:
        return self.lookup(key)

    def lookup(self, key: Hashable, *, record_miss: bool = True) -> Optional[Any]:
        with self._lock:
            hit, val = self._get_locked(key, record_miss=record_miss)
        self._pool._on_lookup(self, key, hit, record_miss=record_miss)
        return val

    def insert(self, key: Hashable, value: Any) -> None:
        self.insert_hinted(key, value)

    def insert_hinted(
        self, key: Hashable, value: Any, *, recompute_cost: Optional[int] = None
    ) -> None:
        with self._lock:
            _, evicted = self._insert_locked(key, value)
        self._pool._on_insert(self, key, value, evicted, recompute_cost=recompute_cost)

    def pop(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            val = self._pop_locked(key)
        if val is not None:
            self._pool._forget(self, [key])
        return val

    def clear(self) -> None:
        with self._lock:
            keys = list(self._data.keys())
            self._data.clear()
        self._pool._forget(self, keys)

    def _evict_for_pool(self, key: Hashable) -> None:
        """Pool-chosen victim: remove locally without calling back."""
        with self._lock:
            if self._data.pop(key, None) is not None:
                self.stats.evictions += 1

    def release(self) -> None:
        """Empty this cache and deregister it from the pool.

        Must be called when the owning reader closes (the fetcher's shutdown
        does) — otherwise dead caches would pin their bytes against the tier
        budget and accumulate in the pool registry forever.
        """
        self.clear()
        self._pool._deregister(self)


class CachePool:
    def __init__(
        self,
        budget_bytes: int,
        *,
        access_fraction: float = 0.25,
        max_tenant_fraction: float = 0.5,
        size_of=default_size_of,
    ):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        if not 0.0 < access_fraction < 1.0:
            raise ValueError("access_fraction must be in (0, 1)")
        self.budget_bytes = budget_bytes
        self.max_tenant_fraction = max_tenant_fraction
        self._size_of = size_of
        self._lock = threading.RLock()
        self._tiers: Dict[str, _Tier] = {
            ACCESS: _Tier(max(1, int(budget_bytes * access_fraction))),
            PREFETCH: _Tier(max(1, budget_bytes - int(budget_bytes * access_fraction))),
        }
        self._tenants: Dict[str, TenantStats] = {}
        self._tenant_weights: Dict[str, float] = {}
        self._cache_id_seq = 0
        self._caches: List[PooledCache] = []

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Scale ``tenant``'s soft-isolation share: its per-tier cap becomes
        ``budget * max_tenant_fraction * weight`` (default weight 1.0)."""
        if weight <= 0:
            raise ValueError("weight must be > 0")
        with self._lock:
            self._tenant_weights[tenant] = float(weight)

    # -- construction -------------------------------------------------------

    def _next_cache_id(self) -> int:
        with self._lock:
            self._cache_id_seq += 1
            return self._cache_id_seq

    def cache(self, *, tier: str, tenant: str = "default", capacity: Optional[int] = None) -> PooledCache:
        """New member cache charged to ``tenant`` in ``tier``."""
        if tier not in self._tiers:
            raise ValueError("tier must be one of %r" % sorted(self._tiers))
        c = PooledCache(self, tier, tenant, capacity)
        with self._lock:
            self._tenants.setdefault(tenant, TenantStats())
            self._caches.append(c)
        return c

    def reader_caches(
        self, tenant: str, *, access_capacity: int = 4, prefetch_capacity: Optional[int] = None
    ) -> Tuple[PooledCache, PooledCache]:
        """(access_cache, prefetch_cache) pair for one ParallelGzipReader."""
        return (
            self.cache(tier=ACCESS, tenant=tenant, capacity=access_capacity),
            self.cache(tier=PREFETCH, tenant=tenant, capacity=prefetch_capacity),
        )

    # -- member-cache callbacks --------------------------------------------

    def _on_lookup(
        self, cache: PooledCache, key: Hashable, hit: bool, record_miss: bool = True
    ) -> None:
        with self._lock:
            tier = self._tiers[cache._tier]
            stats = self._tenants.setdefault(cache.tenant, TenantStats())
            if hit:
                stats.hits += 1
                entry = tier.entries.pop((cache._cache_id, key), None)
                if entry is not None:
                    entry.skips = 0  # re-accessed: young again for aging
                    tier.entries[(cache._cache_id, key)] = entry  # move to MRU
            elif record_miss:
                stats.misses += 1

    def _on_insert(
        self,
        cache: PooledCache,
        key: Hashable,
        value: Any,
        evicted: List[Tuple[Hashable, Any]],
        recompute_cost: Optional[int] = None,
    ) -> None:
        size = self._size_of(value)
        # Unhinted entries cost exactly their size: uniform cost density, so
        # victim selection degrades to plain global LRU.
        cost = size if recompute_cost is None else max(0, int(recompute_cost))
        victims: List[Tuple[PooledCache, Hashable]] = []
        with self._lock:
            if not cache._pool_registered:
                # Released cache: nobody will ever deregister this charge
                # again, so booking it would leak tier.held bytes for good.
                # The orphaned value sits only in the abandoned member dict.
                return
            tier = self._tiers[cache._tier]
            stats = self._tenants.setdefault(cache.tenant, TenantStats())
            for k, _ in evicted:  # entry-capacity evictions inside the cache
                self._forget_locked(tier, cache, k)
            # Unconditionally decharge any prior ledger entry for this key —
            # not just when `replaced` says so: two same-key inserts can race
            # in the gap between the cache lock and this pool lock, and an
            # overwrite without decharge would leak bytes into tier.held
            # permanently.
            self._forget_locked(tier, cache, key)
            tier.entries[(cache._cache_id, key)] = _Entry(cache, size, cost)
            tier.held += size
            stats.bytes_held += size
            stats.insertions += 1
            victims = self._select_victims_locked(tier, cache, key, stats)
        for victim_cache, victim_key in victims:
            victim_cache._evict_for_pool(victim_key)

    def _tenant_cap_locked(self, tier: _Tier, tenant: str) -> int:
        weight = self._tenant_weights.get(tenant, 1.0)
        return int(tier.budget * self.max_tenant_fraction * weight)

    def _select_victims_locked(
        self, tier: _Tier, cache: PooledCache, new_key: Hashable, inserter: TenantStats
    ) -> List[Tuple[PooledCache, Hashable]]:
        victims: List[Tuple[PooledCache, Hashable]] = []

        def take(pred) -> bool:
            # Cost-aware LRU: among the first EVICTION_WINDOW matching
            # entries from the LRU end, evict the one cheapest to recompute
            # per byte. Ties (and unhinted entries, cost == size) fall back
            # to strict LRU order. Aging keeps expensive entries mortal: an
            # entry passed over EVICTION_WINDOW times — a full window of
            # younger victims died around it without it being re-accessed —
            # is evicted regardless of cost (a lookup resets the counter).
            best_key = None
            best_density = None
            scanned = []
            for (cid, k), e in tier.entries.items():
                if (cid, k) == (cache._cache_id, new_key):
                    continue  # never evict the entry being inserted
                if not pred(e.cache):
                    continue
                if e.skips >= EVICTION_WINDOW:
                    best_key = (cid, k)
                    break
                density = e.cost / max(1, e.size)
                if best_density is None or density < best_density:
                    best_key = (cid, k)
                    best_density = density
                scanned.append(((cid, k), e))
                if len(scanned) >= EVICTION_WINDOW:
                    break
            if best_key is None:
                return False
            for key_e, e in scanned:  # only entries older than the victim age
                if key_e == best_key:
                    break
                e.skips += 1
            e = tier.entries.pop(best_key)
            tier.held -= e.size
            tier.evictions += 1
            tier.evicted_bytes += e.size
            tier.evicted_cost += e.cost
            owner = self._tenants.setdefault(e.cache.tenant, TenantStats())
            owner.bytes_held -= e.size
            owner.evictions_suffered += 1
            owner.eviction_cost_suffered += e.cost
            inserter.evictions_caused += 1
            inserter.eviction_cost_caused += e.cost
            victims.append((e.cache, best_key[1]))
            return True

        # Soft isolation: a tenant over its (weighted) fair share sheds its
        # own entries before anyone else's.
        tenant_cap = self._tenant_cap_locked(tier, cache.tenant)
        while inserter.bytes_held > tenant_cap and tier.held > tier.budget:
            if not take(lambda c: c.tenant == cache.tenant):
                break
        while tier.held > tier.budget:
            if not take(lambda c: True):
                break  # only the new entry remains; let it stay
        return victims

    def _forget(self, cache: PooledCache, keys: List[Hashable]) -> None:
        with self._lock:
            tier = self._tiers[cache._tier]
            for k in keys:
                self._forget_locked(tier, cache, k)

    def _deregister(self, cache: PooledCache) -> None:
        """Remove a released cache (and any ledger remnants) from the pool."""
        with self._lock:
            cache._pool_registered = False
            tier = self._tiers[cache._tier]
            stale = [key for key in tier.entries if key[0] == cache._cache_id]
            for key in stale:
                self._forget_locked(tier, cache, key[1])
            try:
                self._caches.remove(cache)
            except ValueError:
                pass

    def _forget_locked(self, tier: _Tier, cache: PooledCache, key: Hashable) -> None:
        entry = tier.entries.pop((cache._cache_id, key), None)
        if entry is not None:
            tier.held -= entry.size
            owner = self._tenants.setdefault(cache.tenant, TenantStats())
            owner.bytes_held -= entry.size

    # -- introspection ------------------------------------------------------

    def bytes_held(self, tier: Optional[str] = None) -> int:
        with self._lock:
            if tier is not None:
                return self._tiers[tier].held
            return sum(t.held for t in self._tiers.values())

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {name: s.as_dict() for name, s in self._tenants.items()}

    def snapshot(self) -> Dict[str, Any]:
        """Atomic pool-wide view: tier occupancy + per-tenant accounting +
        merged member-cache stats (via CacheStats.merge)."""
        with self._lock:
            tiers = {
                name: {
                    "budget": t.budget,
                    "held": t.held,
                    "entries": len(t.entries),
                    "evictions": t.evictions,
                    "evicted_bytes": t.evicted_bytes,
                    "evicted_cost": t.evicted_cost,
                }
                for name, t in self._tiers.items()
            }
            tenants = {name: s.as_dict() for name, s in self._tenants.items()}
            weights = dict(self._tenant_weights)
            caches = list(self._caches)
        merged = CacheStats().merge(*(c.snapshot()["stats"] for c in caches))
        return {
            "budget_bytes": self.budget_bytes,
            "tiers": tiers,
            "tenants": tenants,
            "tenant_weights": weights,
            "merged_cache_stats": merged.as_dict(),
            "n_caches": len(caches),
        }
