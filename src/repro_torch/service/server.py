"""ArchiveServer — many gzip files, many clients, one resource budget.

The paper's architecture (cache + prefetcher + thread pool, §3.2) serves one
reader over one file. This server multiplexes a registry of
`ParallelGzipReader`s behind a single shared budget:

  * **memory** — every reader's access/prefetch caches are `PooledCache`s
    drawn from one `CachePool`, so fleet memory is bounded by the pool
    budget, not by (readers x per-reader maxima);
  * **CPU** — every reader's fetcher submits into one `FairExecutor`
    (byte-weighted deficit round-robin + per-tenant priority lanes), so a
    hot tenant's prefetch stream cannot starve another tenant's first read,
    measured in bytes of decompression work rather than task counts;
  * **index reuse** — opens consult an `IndexStore`; a warm hit skips the
    speculative first pass entirely (zero nominal tasks), closes persist
    finalized indexes back.

API: ``open(source) -> handle``, ``read_range(handle, offset, size)``,
``stat(handle)``, ``close(handle)``. Readers are opened lazily on first use.

Concurrency contract (who locks what):

  * ``read_range`` is **stateless and concurrent**: it rides
    `ParallelGzipReader.pread`, which has no shared cursor. N threads
    hammering one handle serialize only where the physics demands it —
    advancing the speculative first pass past uncovered offsets (the
    reader's narrow frontier lock, one chunk per acquisition). With a warm
    (finalized) index no server- or reader-level lock is taken at all;
    aggregate throughput scales with the executor, not with handle count.
    ``read_range(..., serialized=True)`` keeps the legacy one-cursor-
    per-handle discipline (entry lock around seek+read) for A/B
    measurement — see bench_service's concurrent-scaling scenario.
  * the **entry lock** is a lifecycle lock only: lazy open (exactly one
    thread builds the reader) and close (nobody closes a reader out from
    under an opener). Reads never hold it.
  * reads and ``close`` shake hands through a per-entry **condition**
    (``_Entry.cond``): each read registers in ``in_flight`` (refusing
    closed entries with KeyError), and ``close`` flips ``closed`` then
    drains ``in_flight`` to zero before the reader's file handle goes away
    — a racing read either completes on a live fd or fails cleanly, never
    preads a closed (or fd-recycled) descriptor. The per-entry read/byte
    counters ride the same condition's lock; hot concurrent reads contend
    on nothing coarser.
  * ``stat`` is **lock-free**: it reads a snapshot of the entry and the
    index's own internally-consistent counters, so telemetry stays
    responsive while long first-pass reads are in flight on the same
    handle.

For asyncio front-ends use `service.async_server.AsyncArchiveServer`, which
bridges these calls off the event loop and adds a concurrent ``read_many``.

Adapted from the JAX package's ``service/server.py`` in how stage 2 is
resolved. ``device`` ("cuda" by default) names the card of the server's own
`TorchDecodeEngine`; building it raises when the card or its kernels are
missing, and the server never serves on the CPU in its place. Every reader
and the transcoder get that engine as their resolver, never None (a port
reader without one would take the process-wide CUDA engine), so
``metrics()["engine"]`` is the engine that did the work.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.reader import ParallelGzipReader
from ..core.remote import RemoteFileReader, is_remote_url
from ..kernels.engine import TorchDecodeEngine
from ..obs import hist as _obs_hist
from ..obs import trace as _obs_trace
from . import metrics as _metrics
from .cache_pool import PREFETCH, CachePool
from .index_store import IndexStore
from .scheduler import FairExecutor
from .transcode import TranscodeManager, resolve_source


@dataclass
class ArchiveStat:
    handle: str
    tenant: str
    opened: bool
    compressed_size: Optional[int]
    decompressed_size: Optional[int]  # None until the index is finalized
    index_points: int
    index_finalized: bool
    index_was_warm: bool  # True when the open hit the IndexStore
    reads: int
    bytes_served: int
    #: IndexStore.file_identity hex key (None until the reader opened) —
    #: the gateway derives the wire ETag from this, so a replaced source
    #: revalidates exactly like the index store re-keys.
    identity: Optional[str] = None
    #: Resolved codec tag ("deflate"/"bgzf"/"zstd") once the reader opened;
    #: before that, the tag requested at open() (None = auto-detect).
    codec: Optional[str] = None
    #: Twin codec tag when the open resolved to a transcoded twin (the
    #: handle serves bit-identical bytes from the re-encoded copy while
    #: `identity` still keys — and the ETag still names — the origin).
    twin: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class _Entry:
    def __init__(self, handle: str, source, tenant: str, codec: Optional[str] = None):
        self.handle = handle
        self.source = source
        self.tenant = tenant
        #: Codec tag requested at open() (None = auto-detect); replaced by
        #: the reader's resolved tag once the lazy open runs.
        self.codec = codec
        # Lifecycle lock: lazy open / close / persist. Positional reads never
        # take it (pread is stateless); serialized=True legacy reads do.
        self.lock = threading.RLock()
        # Condition guarding the per-entry counters AND the read/close
        # handshake: reads register in `in_flight` under it (refusing closed
        # entries), close() flips `closed` and drains `in_flight` to zero
        # before the reader's file handle goes away — without this, a
        # lock-free read racing close() could pread a closed (or, after fd
        # reuse, a *different*) file descriptor. Cheap enough to take per
        # request without re-serializing the reads themselves.
        self.cond = threading.Condition()
        self.in_flight = 0
        self.reader: Optional[ParallelGzipReader] = None
        self.identity: Optional[str] = None
        self.index_was_warm = False
        #: Twin codec tag when resolution bound this handle to a transcoded
        #: twin; None while serving the origin bytes directly.
        self.twin: Optional[str] = None
        #: One hostility probe per handle: set the first time a finalized
        #: first pass is offered to the TranscodeManager (which dedups by
        #: identity anyway — this flag just keeps the hot path cheap).
        self.transcode_probed = False
        self.reads = 0
        self.bytes_served = 0
        self.closed = False


class ArchiveServer:
    def __init__(
        self,
        *,
        max_workers: int = 8,
        cache_budget_bytes: int = 64 << 20,
        access_fraction: float = 0.25,
        max_tenant_fraction: float = 0.5,
        index_store: Optional[IndexStore] = None,
        chunk_size: int = 1 << 20,
        reader_parallelization: int = 4,
        access_cache_entries: int = 4,
        verify: bool = True,
        fairness: str = "drr",
        quantum_bytes: Optional[int] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        tenant_quanta: Optional[Dict[str, float]] = None,
        remote_options: Optional[Dict[str, Any]] = None,
        device_engine: Any = "auto",
        engine_options: Optional[Dict[str, Any]] = None,
        transcode: Any = "auto",
        transcode_options: Optional[Dict[str, Any]] = None,
        cost_correction: bool = True,
        slow_request_s: Optional[float] = 1.0,
        slow_log_entries: int = 32,
        device: str = "cuda",
    ):
        # One batched stage-2 engine per server, shared by every
        # reader/tenant like the executor and cache pool — cross-reader
        # batching is the whole point (kernels/engine.py). Built first, so
        # an engine that cannot be built leaves no pool threads behind.
        # "auto" builds one on ``device``, and any error building it
        # propagates; "off"/None/False run stage 2 on the host through a
        # device="cpu" engine (the kernels' plain versions), owned like the
        # "auto" one; an object with a ``replace_markers`` attribute is used
        # as an externally owned engine and is NOT shut down with the server.
        self._owns_engine = False
        if hasattr(device_engine, "replace_markers"):
            self.device_engine = device_engine
        elif device_engine in ("auto", None, False, "off"):
            self.device_engine = TorchDecodeEngine(
                device=device if device_engine == "auto" else "cpu",
                **(engine_options or {}),
            )
            self._owns_engine = True
        else:
            raise ValueError(
                "device_engine must be 'auto', 'off'/None/False, or an engine"
            )
        #: kwargs forwarded to every RemoteFileReader the server opens for
        #: http(s):// sources: auth headers, block_size/cache_blocks,
        #: timeout, retry tuning. The remote block caches themselves are
        #: pool-backed (prefetch tier, cache_blocks entries), so their
        #: resident bytes count against the owning tenant's shared budget.
        self.remote_options = dict(remote_options or {})
        self.cache_pool = CachePool(
            cache_budget_bytes,
            access_fraction=access_fraction,
            max_tenant_fraction=max_tenant_fraction,
        )
        for tenant, weight in (tenant_weights or {}).items():
            self.cache_pool.set_tenant_weight(tenant, weight)
        # Quantum defaults to a quarter chunk: a zlib-delegated indexed task
        # dispatches nearly every round-robin visit while a marker-mode
        # speculative decode (2x chunk) banks ~8 visits of deficit first.
        # cost_correction: byte-cost hints are claims; the executor's EWMA of
        # observed runtime re-prices them so a tenant whose "1 MiB" tasks run
        # like 4 MiB (marker-mode two-stage decodes, cold page cache) drains
        # deficit at the observed rate. On by default here — server-submitted
        # work has runtimes roughly proportional to bytes, so honest tenants
        # converge to factor 1.0.
        self.executor = FairExecutor(
            max_workers,
            fairness=fairness,
            quantum_bytes=quantum_bytes if quantum_bytes is not None else max(1, chunk_size // 4),
            cost_correction=cost_correction,
        )
        # Weighted DRR: a tenant's per-pass deficit replenishment scales
        # with its factor (paying tenants get a larger quantum). Also
        # settable per-open via ``open(..., quantum=...)``.
        for tenant, factor in (tenant_quanta or {}).items():
            self.executor.set_tenant_quantum(tenant, factor)
        self.index_store = index_store if index_store is not None else IndexStore()
        # Background transcoder: archives whose first pass probes
        # seek-hostile (Codec.seek_hostility above threshold) get re-encoded
        # as a seekable twin on the executor's batch lane; later opens
        # resolve to the twin transparently (service/transcode.py). Same
        # ownership contract as the engine: "auto" builds one over this
        # server's store+executor, "off"/None/False disables, an object with
        # a ``consider`` attribute is externally owned.
        self.transcoder: Optional[TranscodeManager] = None
        self._owns_transcode = False
        if hasattr(transcode, "consider"):
            self.transcoder = transcode
        elif transcode == "auto":
            self.transcoder = TranscodeManager(
                self.index_store,
                self.executor,
                resolver=self.device_engine,
                **(transcode_options or {}),
            )
            self._owns_transcode = True
        elif transcode not in (None, False, "off"):
            raise ValueError(
                "transcode must be 'auto', 'off'/None/False, or a manager"
            )
        self.chunk_size = chunk_size
        self.reader_parallelization = reader_parallelization
        self.access_cache_entries = access_cache_entries
        self.verify = verify

        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._handle_seq = 0
        self._closed = False
        # Front-door gauges (metrics "service" section): how many read_range
        # calls are inside the server right now, and cumulative counts split
        # by discipline. Guarded by a micro-lock of their own so the hot
        # path never touches the registry lock.
        self._gauge_lock = threading.Lock()
        self._reads_in_flight = 0
        self._reads_started = 0
        self._reads_serialized = 0
        # Snapshot provenance (metrics satellite): wall/monotonic anchors so
        # scrapers can compute rates and detect restarts, plus a sequence
        # number that makes snapshot ordering explicit.
        self._started_wall = time.time()
        self._started_mono = time.monotonic()
        self._snapshot_seq = 0
        # Threshold-gated slow-request log: reads slower than
        # ``slow_request_s`` (None disables) land here with their span tree
        # attached when tracing is on. Bounded; newest wins.
        self._slow_request_s = slow_request_s
        self._slow_lock = threading.Lock()
        self._slow_log: deque = deque(maxlen=max(1, slow_log_entries))

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------

    def open(
        self,
        source,
        *,
        tenant: str = "default",
        quantum: Optional[float] = None,
        codec: Optional[str] = None,
    ) -> str:
        """Register an archive source; the reader is created lazily on first
        use.

        ``source`` is anything `ParallelGzipReader` accepts: a path, bytes,
        an ``http(s)://`` URL (served via range-GET preads, never fully
        downloaded), or a FileReader. ``codec`` pins the format tag
        ("deflate"/"bgzf"/"zstd"); None auto-detects from the head bytes at
        lazy-open time (BGZF by its BC subfield, zstd by frame magic, with
        a deflate fallback that never errors on valid gzip). ``quantum``
        optionally (re)sets the tenant's weighted-DRR quantum factor (see
        `FairExecutor.set_tenant_quantum`) — a per-open convenience for
        callers that learn the tenant's service class at open time (the
        gateway's admission control does).
        """
        if quantum is not None:
            self.executor.set_tenant_quantum(tenant, quantum)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._handle_seq += 1
            handle = "f%d" % self._handle_seq
            self._entries[handle] = _Entry(handle, source, tenant, codec)
        return handle

    def _entry(self, handle: str) -> _Entry:
        with self._lock:
            entry = self._entries.get(handle)
        if entry is None or entry.closed:
            raise KeyError("unknown or closed handle %r" % handle)
        return entry

    def _ensure_reader(self, entry: _Entry) -> ParallelGzipReader:
        with entry.lock:
            # Re-check under the entry lock: a concurrent close() may have
            # won the race after our registry lookup. Without this, a lazy
            # open here would build a reader (and register pooled caches)
            # that nothing ever closes.
            if entry.closed:
                raise KeyError("unknown or closed handle %r" % entry.handle)
            if entry.reader is not None:
                return entry.reader
            source = entry.source
            access_cache = prefetch_cache = block_cache = None
            try:
                if is_remote_url(source):
                    # Open the remote backend once: the identity probe and
                    # the reader then share one set of open-time validators
                    # (and one HEAD), and `ParallelGzipReader.close` owns its
                    # lifetime. Its block cache is pool-backed, so the
                    # cache_blocks x block_size of readahead bytes are
                    # charged to this tenant's shared budget (prefetch tier)
                    # instead of sitting beside it.
                    opts = dict(self.remote_options)
                    block_cache = self.cache_pool.cache(
                        tier=PREFETCH,
                        tenant=entry.tenant,
                        capacity=int(opts.pop("cache_blocks", 16)),
                    )
                    source = RemoteFileReader(source, block_cache=block_cache, **opts)
                # Source resolution: identity and the reader must agree on
                # the codec (an explicit tag pins both; auto-detection probes
                # the same head bytes in both places), and the store may know
                # a transcoded twin for this identity — in which case the
                # handle binds to the twin's bytes/index while `identity`
                # (and thus the ETag and fleet placement) stays the origin's.
                origin = source
                resolved = resolve_source(
                    self.index_store, origin, codec=entry.codec
                )
                entry.identity = resolved.identity
                entry.index_was_warm = resolved.index_was_warm
                entry.twin = resolved.twin
                source = resolved.source
                if resolved.twin is not None and origin is not entry.source:
                    # Twin-bound: the read path never touches the origin
                    # again, so the remote backend (and its pool-backed
                    # block cache) opened for the identity probe goes back.
                    origin.close()
                    if block_cache is not None:
                        block_cache.release()
                        block_cache = None
                access_cache, prefetch_cache = self.cache_pool.reader_caches(
                    entry.tenant, access_capacity=self.access_cache_entries
                )
                entry.reader = ParallelGzipReader(
                    source,
                    parallelization=self.reader_parallelization,
                    chunk_size=self.chunk_size,
                    index=resolved.index,
                    verify=self.verify,
                    codec=resolved.codec,
                    executor=self.executor.view(entry.tenant),
                    access_cache=access_cache,
                    prefetch_cache=prefetch_cache,
                    resolver=self.device_engine,
                )
                entry.codec = entry.reader.codec.tag
            except BaseException:
                # Corrupt/non-gzip source, torn index blob, or a pool fault:
                # return the caches to the pool and close the remote reader
                # we opened, or client retries would grow connections and
                # registrations without bound. ParallelGzipReader's own
                # constructor already tears down what it reached (fetcher,
                # caches, file handle); this backstop covers failures before
                # the reader constructor ran (identity probe, index store)
                # and is harmless after it — PooledCache.release and
                # FileReader.close are idempotent.
                if access_cache is not None:
                    access_cache.release()
                    prefetch_cache.release()
                if block_cache is not None:
                    block_cache.release()  # idempotent if close() already did
                if source is not entry.source and hasattr(source, "close"):
                    source.close()  # twin paths are plain strings: no-op
                raise
            return entry.reader

    def _maybe_transcode(self, entry: _Entry, reader: ParallelGzipReader) -> None:
        """Offer a freshly finalized first pass to the transcoder, once.

        Called from the read paths after the reader worked: only a
        *finalized* index carries the first-pass observations the hostility
        score needs, and only an origin-bound handle should probe (a twin is
        the transcode's output, never its input). Remote origins are skipped
        — re-encoding somebody else's URL into a local twin would pin the
        fleet's placement to this node. The probed flag is a benign race:
        the manager dedups by identity.
        """
        mgr = self.transcoder
        if (
            mgr is None
            or entry.twin is not None
            or entry.transcode_probed
            or not reader.index.finalized
            or is_remote_url(entry.source)
        ):
            return
        entry.transcode_probed = True
        try:
            mgr.consider(entry.identity, entry.source, reader)
        except Exception:  # noqa: BLE001 - background QoS must not fail reads
            pass

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def read_range(
        self, handle: str, offset: int, size: int, *, serialized: bool = False
    ) -> bytes:
        """Decompressed bytes [offset, offset+size) — short at EOF.

        Concurrent and stateless: no per-handle cursor, no entry lock. The
        entry lock is taken only inside ``_ensure_reader`` when this is the
        first touch of a lazily-opened handle; after that, N threads on one
        handle proceed in parallel (index-covered ranges entirely lock-free,
        frontier advancement serialized inside the reader one chunk at a
        time). ``serialized=True`` restores the legacy discipline — entry
        lock around a shared-cursor seek+read — kept for A/B benchmarking.
        """
        if offset < 0 or size < 0:
            raise ValueError("offset and size must be non-negative")
        entry = self._entry(handle)
        # Always-on latency boundary: the duration histogram records even
        # while tracing is off; with tracing on this is the read's span (the
        # root, unless a gateway request is already the current context).
        read_span = _obs_trace.timed(
            "server.read_range",
            {
                "handle": handle,
                "tenant": entry.tenant,
                "offset": offset,
                "size": size,
                "serialized": serialized,
            },
        )
        t0 = time.perf_counter()
        with read_span:
            reader = entry.reader
            if reader is None:
                reader = self._ensure_reader(entry)
            with entry.cond:
                # Register under the close handshake: after this, close()
                # waits for us before tearing the reader (and its fd) down.
                if entry.closed:
                    raise KeyError("unknown or closed handle %r" % handle)
                entry.in_flight += 1
            with self._gauge_lock:
                self._reads_in_flight += 1
                self._reads_started += 1
                if serialized:
                    self._reads_serialized += 1
            try:
                if serialized:
                    with entry.lock:
                        reader.seek(offset)
                        data = reader.read(size)
                else:
                    data = reader.pread(offset, size)
            finally:
                with self._gauge_lock:
                    self._reads_in_flight -= 1
                with entry.cond:
                    entry.in_flight -= 1
                    if entry.in_flight == 0:
                        entry.cond.notify_all()
        duration = time.perf_counter() - t0
        if self._slow_request_s is not None and duration >= self._slow_request_s:
            self._log_slow_read(entry, offset, size, duration, read_span)
        with entry.cond:
            entry.reads += 1
            entry.bytes_served += len(data)
        self._maybe_transcode(entry, reader)
        return data

    def _log_slow_read(
        self, entry: _Entry, offset: int, size: int, duration: float, read_span
    ) -> None:
        """Record one over-threshold read; attach its span tree if traced."""
        record: Dict[str, Any] = {
            "ts": time.time(),
            "handle": entry.handle,
            "tenant": entry.tenant,
            "offset": offset,
            "size": size,
            "duration_s": round(duration, 6),
            "trace_id": getattr(read_span, "trace_id", None),
        }
        if record["trace_id"] is not None:
            tree = _obs_trace.span_tree(record["trace_id"])
            t_first = tree[0]["ts"] if tree else 0.0
            record["spans"] = [
                {
                    "name": s["name"],
                    "start_offset_s": round(s["ts"] - t_first, 6),
                    "dur_s": round(s["dur_s"], 6),
                    "span_id": s["span_id"],
                    "parent_id": s["parent_id"],
                    "thread": s["thread_name"],
                }
                for s in tree
            ]
        with self._slow_lock:
            self._slow_log.append(record)

    def read_many(
        self, requests: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        """Serve many ``(handle, offset, size)`` ranges, in order.

        Runs sequentially in the calling thread — the parallelism callers
        want lives either in their own threads (each calling read_range) or
        in `AsyncArchiveServer.read_many`, which fans these out across the
        front-end bridge concurrently.
        """
        return [self.read_range(h, off, size) for h, off, size in requests]

    def stat(self, handle: str) -> ArchiveStat:
        """Lock-free snapshot of one handle.

        Deliberately does NOT take the entry lock: a long first-pass read (or
        a slow lazy open) on the same handle must not make telemetry hang.
        The index reports through its own internal lock; the counters come
        from the stats micro-lock; `opened` reflects the reader reference at
        the instant of the call.
        """
        entry = self._entry(handle)
        reader = entry.reader
        index = reader.index if reader is not None else None
        with entry.cond:
            reads, bytes_served = entry.reads, entry.bytes_served
        return ArchiveStat(
            handle=handle,
            tenant=entry.tenant,
            opened=reader is not None,
            compressed_size=(
                index.compressed_size if index is not None else None
            ),
            decompressed_size=(
                index.decompressed_size if index is not None else None
            ),
            index_points=len(index) if index is not None else 0,
            index_finalized=bool(index.finalized) if index is not None else False,
            index_was_warm=entry.index_was_warm,
            reads=reads,
            bytes_served=bytes_served,
            identity=entry.identity,
            codec=entry.codec,
            twin=entry.twin,
        )

    def size(self, handle: str) -> int:
        """Decompressed size (drives the first pass to completion).

        No entry lock: the reader's own frontier lock serializes the first
        pass, and concurrent read_range calls on the same handle keep
        flowing while it completes.
        """
        entry = self._entry(handle)
        reader = entry.reader
        if reader is None:
            reader = self._ensure_reader(entry)
        with entry.cond:
            if entry.closed:
                raise KeyError("unknown or closed handle %r" % handle)
            entry.in_flight += 1
        try:
            return reader.size()
        finally:
            with entry.cond:
                entry.in_flight -= 1
                if entry.in_flight == 0:
                    entry.cond.notify_all()
            self._maybe_transcode(entry, reader)

    def cancel_queued(self, handle: str) -> int:
        """Cancel the handle's queued batch-lane prefetch tasks, if idle.

        The gateway calls this when a client disconnects mid-stream: the
        speculation that client motivated should stop consuming executor
        bandwidth. Scoped to the handle's reader view and to the *batch*
        lane only, and skipped entirely while other reads are in flight on
        the handle (their latency-hiding prefetches stay). Cancelled tasks
        are booked under the executor's ``cancelled`` counter, so
        ``submitted == done + cancelled + queued`` always balances.
        """
        entry = self._entry(handle)
        reader = entry.reader
        if reader is None:
            return 0
        with entry.cond:
            if entry.closed or entry.in_flight:
                return 0
        return reader.cancel_prefetches()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def persist_index(self, handle: str) -> Optional[str]:
        """Store the handle's index if finalized; returns the store key.

        Twin-bound handles never persist: their live index describes the
        *twin's* byte layout, and `entry.identity` keys the *origin* — a put
        here would poison the origin's index slot for every non-twin open.
        The origin's own finalized index was persisted by the transcoder at
        schedule time.
        """
        entry = self._entry(handle)
        with entry.lock:
            if (
                entry.reader is None
                or entry.twin is not None
                or not entry.reader.index.finalized
            ):
                return None
            return self.index_store.put(entry.identity, entry.reader.index)

    def index_blob(self, handle: str) -> Optional[tuple]:
        """(identity key, finalized index blob) for a handle, else None.

        The serving side of the fleet index exchange: a live finalized
        reader serializes its in-memory index; a lazy (never-read) handle
        can still be served from the local store if a previous session
        persisted it. Non-finalized indexes are never exported — an importer
        would trust seek points that the speculative pass has not confirmed.
        Twin-bound handles fall through to the store: a peer asking for this
        identity wants the *origin's* index (it holds the origin's bytes),
        not the local twin's layout.
        """
        entry = self._entry(handle)
        with entry.lock:
            if (
                entry.reader is not None
                and entry.twin is None
                and entry.reader.index.finalized
            ):
                return entry.identity, entry.reader.index.to_bytes()
            if entry.identity is not None:
                blob = self.index_store.get_blob(entry.identity)
                if blob is not None:
                    return entry.identity, blob
        return None

    def close(self, handle: str, *, persist_index: bool = True) -> None:
        entry = self._entry(handle)
        with entry.cond:
            if entry.closed:
                return
            # Refuse new reads first, then drain the in-flight ones: the
            # reader's file handle must not close under a lock-free pread
            # (EBADF at best; with fd-number reuse, bytes from a different
            # file at worst). Like the old entry-lock discipline, close
            # waits for reads already admitted — but no longer blocks
            # telemetry or other handles while it does.
            entry.closed = True
            while entry.in_flight:
                entry.cond.wait()
        with entry.lock:
            if entry.reader is not None:
                # Twin-bound handles skip the persist: entry.identity keys
                # the origin, but the live index maps the twin's bytes.
                if (
                    persist_index
                    and entry.twin is None
                    and entry.reader.index.finalized
                ):
                    self.index_store.put(entry.identity, entry.reader.index)
                # Reader close cancels its own queued tasks (view-scoped —
                # the tenant may have other files open), releases its pooled
                # caches back to the budget, and leaves the server-owned
                # executor running.
                entry.reader.close()
        with self._lock:
            self._entries.pop(handle, None)

    def close_all(self, *, persist_indexes: bool = True) -> None:
        with self._lock:
            handles = list(self._entries)
        for h in handles:
            try:
                self.close(h, persist_index=persist_indexes)
            except KeyError:
                pass

    def shutdown(self) -> None:
        # Refuse new opens *before* draining the registry: an open() racing
        # into the gap would register an entry nothing ever closes, and its
        # reads would hit the shut-down executor.
        with self._lock:
            self._closed = True
        # Stop the transcoder before the executor: closed managers fail
        # their in-flight jobs cleanly (tmp twins unlinked) instead of
        # racing cancelled futures through half a span chain.
        if self._owns_transcode and self.transcoder is not None:
            self.transcoder.close()
        self.close_all()
        self.executor.shutdown(wait=False, cancel_futures=True)
        # After the executor: no pool worker can submit to the engine once
        # the pool is down, so queued engine futures error instead of hang.
        if self._owns_engine:
            self.device_engine.shutdown()

    def __enter__(self) -> "ArchiveServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Fleet-wide snapshot (see service/metrics.py for the layout).

        Lock-free with respect to reads: reader stats are atomic cache
        snapshots and the per-entry counters sit behind their micro-lock, so
        a telemetry poll never stalls (or is stalled by) a long read.
        """
        reports: Dict[str, Dict[str, Any]] = {}
        per_file: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            if entry.closed:
                continue
            reader = entry.reader
            if reader is not None:
                reports[entry.handle] = reader.stats()
            with entry.cond:
                reads, bytes_served = entry.reads, entry.bytes_served
            per_file[entry.handle] = {
                "tenant": entry.tenant,
                "reads": reads,
                "bytes_served": bytes_served,
                "index_was_warm": entry.index_was_warm,
                "opened": reader is not None,
                "codec": entry.codec,
                "twin": entry.twin,
            }
        with self._gauge_lock:
            service = {
                "reads_in_flight": self._reads_in_flight,
                "reads_started": self._reads_started,
                "reads_serialized": self._reads_serialized,
            }
            self._snapshot_seq += 1
            seq = self._snapshot_seq
        with self._slow_lock:
            slow = list(self._slow_log)
        obs_section = {
            "tracing": _obs_trace.tracing_stats(),
            "histograms": _obs_hist.histogram_snapshots(),
            "slow_request_threshold_s": self._slow_request_s,
            "slow_requests": slow,
        }
        snap = _metrics.collect(
            reader_reports=reports,
            per_file=per_file,
            pool=self.cache_pool,
            executor=self.executor,
            index_store=self.index_store,
            service=service,
            engine=self.device_engine,
            transcode=self.transcoder,
            obs=obs_section,
        )
        # Snapshot provenance: wall timestamp for scrape alignment, a
        # monotonic uptime for rate windows, and a sequence number whose
        # reset (alongside uptime) is the restart signal.
        snap["ts"] = time.time()
        snap["uptime_s"] = round(time.monotonic() - self._started_mono, 3)
        snap["snapshot_seq"] = seq
        return snap
