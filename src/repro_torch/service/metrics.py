"""Fleet telemetry: aggregate per-reader stats into one service snapshot.

Every `ParallelGzipReader` already reports its own cache/fetcher counters
(`reader.stats()`: access/prefetch `CacheStats` plus `FetcherStats`). A
service runs dozens of readers — operators need the *fleet* view: total
speculative work, fleet hit rates, pool occupancy against budget, scheduler
fairness, per-tenant consumption. `collect()` produces that as one plain
dict (JSON-serializable, stable keys), using `CacheStats.merge` so cache
counters aggregate without racing the fetcher threads (each member cache is
snapshotted atomically; sums are computed from the snapshots).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from ..core.cache import CacheStats
from ..core.chunk_fetcher import FetcherStats

#: FetcherStats fields summed across readers — derived from the dataclass so
#: a new core counter can never be silently dropped from fleet aggregation.
_FETCHER_COUNTERS = tuple(FetcherStats.__dataclass_fields__)

#: Frontier-lock counters from `ParallelGzipReader.stats()["frontier"]`:
#: every first-pass advance takes the lock once; `lock_contended` /
#: `lock_wait_s` quantify how often (and for how long) concurrent positional
#: reads actually serialized on it. Warm indexed traffic shows zero
#: acquisitions — the observable proof that pread is lock-free there.
_FRONTIER_COUNTERS = ("lock_acquires", "lock_contended", "lock_wait_s")


def aggregate_reader_reports(reports: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """Sum many ``reader.stats()`` dicts into fleet totals."""
    access = CacheStats()
    prefetch = CacheStats()
    fetcher = {k: 0 for k in _FETCHER_COUNTERS}
    frontier = {k: 0.0 if k == "lock_wait_s" else 0 for k in _FRONTIER_COUNTERS}
    for rep in reports.values():
        access = access.merge(rep.get("access", {}))
        prefetch = prefetch.merge(rep.get("prefetch", {}))
        f = rep.get("fetcher", {})
        for k in _FETCHER_COUNTERS:
            fetcher[k] += int(f.get(k, 0))
        fr = rep.get("frontier", {})
        for k in _FRONTIER_COUNTERS:
            frontier[k] += fr.get(k, 0)
    # The fetcher's combined-stats lookup records exactly one hit or miss
    # per *logical* lookup across the two tiers (access misses are
    # suppressed when the prefetch tier still gets probed), so the
    # meaningful fleet number is the combined rate; per-tier dicts keep the
    # raw counters.
    combined = access.merge(prefetch)
    return {
        "readers": len(reports),
        "access": access.as_dict(),
        "access_hit_rate": access.hit_rate,
        "prefetch": prefetch.as_dict(),
        "prefetch_hit_rate": prefetch.hit_rate,
        "hit_rate": combined.hit_rate,
        "lookups": combined.hits + combined.misses,
        "fetcher": fetcher,
        "frontier": frontier,
    }


def collect(
    *,
    reader_reports: Mapping[str, Mapping[str, Any]],
    per_file: Optional[Mapping[str, Mapping[str, Any]]] = None,
    pool=None,
    executor=None,
    index_store=None,
    service: Optional[Mapping[str, Any]] = None,
    engine=None,
    transcode=None,
    obs: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """One service-wide snapshot. All sections are optional except readers.

    ``service`` carries the server's front-door gauges (in-flight read
    count, cumulative reads split by discipline) — the liveness complement
    to the per-reader frontier lock-wait counters in the fleet section.
    ``engine`` is the server's shared `DeviceDecodeEngine` (or anything with
    ``stats()``): batch counts, tile occupancy, queue depth, and CPU
    fallbacks land in an ``engine`` section.
    """
    out: Dict[str, Any] = {
        "fleet": aggregate_reader_reports(reader_reports),
        "per_file": {h: dict(v) for h, v in (per_file or {}).items()},
        "per_reader": {h: dict(v) for h, v in reader_reports.items()},
    }
    if pool is not None:
        out["cache_pool"] = pool.snapshot()
    if executor is not None:
        out["scheduler"] = executor.snapshot()
    if index_store is not None:
        out["index_store"] = index_store.stats.as_dict()
    if service is not None:
        out["service"] = dict(service)
    if engine is not None:
        out["engine"] = engine.stats()
    if transcode is not None:
        out["transcode"] = transcode.snapshot()
    if obs is not None:
        # Tracing/histogram/slow-read section (repro.obs): the server passes
        # the already-snapshotted dict so collect stays side-effect free.
        out["obs"] = dict(obs)
    return out


def format_summary(snapshot: Mapping[str, Any]) -> str:
    """Human-readable one-screen summary of a `collect()` snapshot."""
    lines = []
    if "ts" in snapshot or "uptime_s" in snapshot:
        lines.append(
            "snapshot #%d at ts=%.3f, uptime %.1fs"
            % (snapshot.get("snapshot_seq", 0), snapshot.get("ts", 0.0),
               snapshot.get("uptime_s", 0.0))
        )
    fleet = snapshot.get("fleet", {})
    f = fleet.get("fetcher", {})
    lines.append(
        "fleet: %d readers, %.1f MiB decompressed, tasks nominal=%d exact=%d indexed=%d"
        % (
            fleet.get("readers", 0),
            f.get("bytes_decompressed", 0) / (1 << 20),
            f.get("nominal_tasks", 0),
            f.get("exact_tasks", 0),
            f.get("indexed_tasks", 0),
        )
    )
    lines.append(
        "caches: hit-rate %.2f over %d logical lookups"
        " (access hits %d, prefetch hit-rate %.2f)"
        % (fleet.get("hit_rate", 0.0), fleet.get("lookups", 0),
           fleet.get("access", {}).get("hits", 0),
           fleet.get("prefetch_hit_rate", 0.0))
    )
    fr = fleet.get("frontier")
    svc = snapshot.get("service")
    if fr or svc:
        fr = fr or {}
        svc = svc or {}
        lines.append(
            "reads: %d in flight, %d started (%d serialized); frontier lock:"
            " %d acquires, %d contended, %.1f ms waited"
            % (svc.get("reads_in_flight", 0), svc.get("reads_started", 0),
               svc.get("reads_serialized", 0), fr.get("lock_acquires", 0),
               fr.get("lock_contended", 0), fr.get("lock_wait_s", 0.0) * 1e3)
        )
    pool = snapshot.get("cache_pool")
    if pool:
        for tier, t in sorted(pool.get("tiers", {}).items()):
            lines.append(
                "pool[%s]: %.1f/%.1f MiB, %d entries, %d evictions"
                " (%.1f MiB, recompute cost %.1f MiB)"
                % (tier, t["held"] / (1 << 20), t["budget"] / (1 << 20),
                   t["entries"], t["evictions"],
                   t.get("evicted_bytes", 0) / (1 << 20),
                   t.get("evicted_cost", 0) / (1 << 20))
            )
        for tenant, t in sorted(pool.get("tenants", {}).items()):
            lines.append(
                "tenant[%s]: %.1f MiB held, %d hits, %d misses, evictions"
                " -%d/+%d (cost -%.1f/+%.1f MiB)"
                % (tenant, t["bytes_held"] / (1 << 20), t["hits"], t["misses"],
                   t["evictions_suffered"], t["evictions_caused"],
                   t.get("eviction_cost_suffered", 0) / (1 << 20),
                   t.get("eviction_cost_caused", 0) / (1 << 20))
            )
    sched = snapshot.get("scheduler")
    if sched:
        lines.append(
            "scheduler[%s]: %d workers, %d/%d tasks done (%d cancelled),"
            " %d queued, %d priority dispatches, dispatch=%s"
            % (sched.get("fairness", "drr"), sched["max_workers"],
               sched["done"], sched["submitted"], sched.get("cancelled", 0),
               sched["queued"],
               sched.get("priority_dispatches", 0), sched["dispatch_per_tenant"])
        )
        db = sched.get("dispatched_bytes_per_tenant", {})
        if db:
            lines.append(
                "scheduler bytes: "
                + ", ".join(
                    "%s=%.1fMiB" % (t, b / (1 << 20)) for t, b in sorted(db.items())
                )
            )
    engine = snapshot.get("engine")
    if engine is not None:
        req = engine.get("requests", {})
        fb = engine.get("fallbacks", {})
        lines.append(
            "engine[%s]: %d batches over %d requests (replace=%d crc=%d),"
            " occupancy %.2f, %d queued (max %d), fallbacks replace=%d crc=%d"
            % ("device" if engine.get("available") else "cpu-only",
               engine.get("batches", 0), engine.get("batched_requests", 0),
               req.get("replace", 0), req.get("crc", 0),
               engine.get("occupancy", 0.0), engine.get("queue_depth", 0),
               engine.get("max_queue_depth", 0),
               fb.get("replace", 0), fb.get("crc", 0))
        )
    tr = snapshot.get("transcode")
    if tr is not None:
        c = tr.get("counters", {})
        lines.append(
            "transcode[%s]: %d considered, %d scheduled, %d installed,"
            " %d failed, %d skipped"
            % (tr.get("twin_codec", "?"), c.get("considered", 0),
               c.get("scheduled", 0), c.get("installed", 0),
               c.get("failed", 0), c.get("skipped_unresolvable", 0))
        )
    store = snapshot.get("index_store")
    if store is not None:
        line = "index store: %d hits, %d misses, %d puts" % (
            store["hits"], store["misses"], store["puts"]
        )
        if store.get("remote_hits") or store.get("remote_misses"):
            line += " (index exchange: %d fetched, %d failed)" % (
                store.get("remote_hits", 0), store.get("remote_misses", 0)
            )
        lines.append(line)
    gateway = snapshot.get("gateway")
    if gateway is not None:
        bridge = snapshot.get("bridge", {})
        lines.append(
            "gateway: %d requests (%d opened, %d reads, %d streams),"
            " %d x 429, %d x 304, %d disconnects,"
            " bridge %d/%d started (%d cancelled)"
            % (gateway.get("requests", 0), gateway.get("opened", 0),
               gateway.get("reads", 0), gateway.get("streams", 0),
               gateway.get("rejected_429", 0),
               gateway.get("not_modified_304", 0),
               gateway.get("disconnects_mid_stream", 0)
               + gateway.get("disconnects_mid_request", 0),
               bridge.get("started", 0), bridge.get("submitted", 0),
               bridge.get("cancelled", 0))
        )
        active = gateway.get("streams_in_progress") or {}
        for sid, st in sorted(active.items()):
            total = st.get("total", 0) or 1
            lines.append(
                "  stream[%s] %s/%s: %d/%d bytes (%.0f%%)"
                % (sid, st.get("tenant", "?"), st.get("handle", "?"),
                   st.get("sent", 0), st.get("total", 0),
                   100.0 * st.get("sent", 0) / total)
            )
    obs = snapshot.get("obs")
    if obs is not None:
        tracing = obs.get("tracing", {})
        hists = obs.get("histograms", {})
        rr = hists.get("server.read_range")
        line = "obs: tracing %s (%d spans recorded)" % (
            "on" if tracing.get("enabled") else "off",
            tracing.get("recorded", 0),
        )
        if rr and rr.get("count"):
            line += ", read_range p50=%.1fms p99=%.1fms over %d" % (
                rr["p50_s"] * 1e3, rr["p99_s"] * 1e3, rr["count"]
            )
        slow = obs.get("slow_requests") or []
        if slow:
            line += ", %d slow request(s) logged" % len(slow)
        lines.append(line)
    router = snapshot.get("router")
    if router is not None:
        membership = router.get("membership", {})
        counters = router.get("counters", {})
        lines.append(
            "fleet router: %d/%d peers alive, %d opens, %d failovers"
            " (%d streams resumed), %d revalidations"
            % (membership.get("alive", 0), membership.get("total", 0),
               counters.get("opens", 0), counters.get("failovers", 0),
               counters.get("resumed_streams", 0),
               counters.get("revalidations", 0))
        )
        for url, peer in sorted(membership.get("peers", {}).items()):
            lines.append(
                "  peer %s: %s, %d consecutive failures, %d probes,"
                " -%d/+%d eject/readmit, %d stuck streams"
                % (url, "alive" if peer.get("alive") else "EJECTED",
                   peer.get("consecutive_failures", 0),
                   peer.get("probes", 0), peer.get("ejections", 0),
                   peer.get("readmissions", 0), peer.get("stuck_streams", 0))
            )
    return "\n".join(lines)
