"""Chunk fetcher: thread pool + caches + prefetcher (paper §3.2/§3.3, Figs 4&5).

Orchestrates parallel chunk decompression:

  * **Nominal (speculative) tasks** — prefetches for chunk index ``k`` run the
    block finder from the nominal offset ``k * chunk_size`` and trial-decode
    candidates until one survives to the stop condition. Results are cached
    keyed by their *actual* start bit offset.
  * **Exact tasks** — the main thread requests chunks by the exact end offset
    of the predecessor. A prefetch that found a false positive simply never
    matches any request key and ages out of the prefetch cache; the main
    thread re-dispatches an exact-offset task (paper §3: "robust against
    false positives").
  * **Indexed tasks** — once seek points exist, chunks decompress from their
    recorded (bit offset, window) — delegated to zlib where possible (paper
    §1.3: >2x faster than two-stage), falling back to the custom decoder for
    chunks containing gzip member boundaries.
  * **Finalization** — window propagation is the only sequential step (last
    32 KiB per chunk); full marker replacement and CRC parts run on the pool
    (paper §2.2's Amdahl mitigation).

Work distribution is dynamic: whichever worker is free takes the next
dispatched chunk — the paper's straggler mitigation (§4.2, §6).

``get_indexed`` is safe to call from many threads concurrently: caches,
in-flight dedup, and the index carry their own locks, and stateful prefetch
strategies are serialized behind ``_strategy_lock``. This is what lets
`ParallelGzipReader.pread` serve index-covered ranges with no reader-level
lock at all.
"""

from __future__ import annotations

import threading
import zlib as _zlib
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from dataclasses import dataclass, field
import time as _time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..obs import trace as _obs_trace
from .cache import LRUCache
from .codec import Codec, resolve_codec
from .deflate import DecodeResult
from .errors import BlockNotFoundError, DeflateError, EndOfStream, RapidgzipError
from .filereader import FileReader
from .index import (
    FLAG_HAS_INTERIOR_MEMBER_END,
    FLAG_STREAM_START,
    FLAG_ZLIB_UNSAFE,
    GzipIndex,
    SeekPoint,
)
from .prefetch import AdaptivePrefetchStrategy, PrefetchStrategy

DEFAULT_CHUNK_SIZE = 4 << 20  # paper §1.4: 4 MiB default compressed chunk size
#: deflate's maximum compression ratio is ~1032 (paper §1.4); the cap guards
#: against runaway false positives without rejecting any legal chunk.
MAX_COMPRESSION_RATIO = 1100


@dataclass
class FetcherStats:
    nominal_tasks: int = 0
    exact_tasks: int = 0
    indexed_tasks: int = 0
    candidates_tried: int = 0
    false_positive_starts: int = 0  # candidates that failed trial decompression
    false_positive_chunks: int = 0  # full chunk results never matched by a request
    redispatches: int = 0  # exact task after prefetch mismatch
    chunks_with_markers: int = 0
    zlib_delegations: int = 0
    bytes_decompressed: int = 0

    def as_dict(self) -> dict:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}


@dataclass
class FinalizedChunk:
    """A chunk whose window has been propagated; bytes may still be in flight."""

    start_bit: int
    end_bit: int
    out_start: int  # global decompressed offset of the chunk start
    size: int
    window_in: Optional[bytes]
    window_out: bytes
    result: DecodeResult
    _bytes_future: Optional[Future] = None
    _bytes: Optional[np.ndarray] = None
    #: CRC32 callable installed by the owning fetcher (resolver-aware);
    #: defaults to zlib for bare FinalizedChunks constructed in tests.
    _crc32: Optional[Callable] = None

    def bytes(self) -> np.ndarray:
        if self._bytes is None:
            assert self._bytes_future is not None
            self._bytes = self._bytes_future.result()
        return self._bytes

    def crc_segments(self) -> List[Tuple[int, int]]:
        """[(segment_length, crc32), ...] split at interior member ends."""
        data = self.bytes()
        crc = self._crc32 or (lambda seg: _zlib.crc32(seg.tobytes()) & 0xFFFFFFFF)
        cuts = [me.out_offset for me in self.result.member_ends]
        segs: List[Tuple[int, int]] = []
        prev = 0
        for c in cuts + [self.size]:
            seg = data[prev:c]
            segs.append((int(seg.shape[0]), crc(seg)))
            prev = c
        return segs


class ChunkFetcher:
    """Parallel chunk decompression engine over a FileReader.

    Format specifics live in ``codec`` (core.codec): candidate finding,
    chunk decoding, native delegation, and the marker machinery are all
    codec methods; everything in this class — caches, in-flight dedup,
    scheduling hints, prefetch strategy, stats — is codec-agnostic.
    """

    def __init__(
        self,
        reader: FileReader,
        *,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        parallelization: int = 4,
        framing: str = "gzip",
        codec: Union[None, str, Codec] = None,
        index: Optional[GzipIndex] = None,
        prefetch_strategy: Optional[PrefetchStrategy] = None,
        access_cache_size: int = 1,
        max_ratio: int = MAX_COMPRESSION_RATIO,
        executor=None,
        access_cache: Optional[LRUCache] = None,
        prefetch_cache: Optional[LRUCache] = None,
        resolver=None,
    ):
        if chunk_size < 1 << 10:
            raise ValueError("chunk_size must be >= 1 KiB")
        self.reader = reader
        self.chunk_size = chunk_size
        self.parallelization = max(1, parallelization)
        # codec=None keeps the historical default (deflate with the given
        # framing) — auto-detection happens one level up, in the reader,
        # which has the head bytes at hand.
        self.codec = resolve_codec(codec, framing=framing)
        self.framing = getattr(self.codec, "framing", framing)
        self.index = index if index is not None else GzipIndex(codec_tag=self.codec.tag)
        if self.index.codec_tag not in self.codec.index_compatible_tags:
            raise RapidgzipError(
                "index codec %r is not servable by the %r codec"
                % (self.index.codec_tag, self.codec.tag)
            )
        self.max_ratio = max_ratio
        self.file_size = reader.size()
        self.total_bits = self.file_size * 8
        self.n_nominal = max(1, -(-self.file_size // chunk_size))

        # The executor and both caches are injectable so a fleet of fetchers
        # can share one thread-pool budget and one memory budget
        # (service/server.py). An injected executor is externally owned:
        # shutdown() leaves it alone.
        self._owns_executor = executor is None
        self.pool = executor if executor is not None else ThreadPoolExecutor(
            max_workers=self.parallelization
        )
        # Separate caches: prefetch traffic must not evict accessed chunks
        # (paper §3.2). Prefetch cache holds 2x parallelism chunks (§1.4).
        # `is None` checks: an injected cache may be empty, and LRUCache
        # defines __len__, so truthiness would silently drop it.
        self.access_cache = (
            access_cache if access_cache is not None else LRUCache(max(1, access_cache_size))
        )
        self.prefetch_cache = (
            prefetch_cache if prefetch_cache is not None else LRUCache(2 * self.parallelization)
        )
        self.strategy = prefetch_strategy or AdaptivePrefetchStrategy(self.parallelization)

        self._lock = threading.Lock()
        # Flipped at shutdown: _blocking_result must stop resubmitting after
        # its future was cancelled by the closing reader's own sweep.
        self._closed = False
        # Prefetch strategies are stateful (stream tracking) and not required
        # to be thread-safe; concurrent positional reads reach on_access from
        # many threads at once, so the fetcher serializes strategy calls.
        self._strategy_lock = threading.Lock()
        self._in_flight: Dict[object, Future] = {}
        self._nominal_done: Dict[int, Optional[int]] = {}  # k -> actual start bit
        self.stats = FetcherStats()

        # Stage-2 resolver (kernels.engine.DeviceDecodeEngine or compatible):
        # shared across fetchers by the service layer like the executor and
        # caches; externally owned, never shut down here. The codec carries
        # it into replace_markers so stage 2 can batch across chunks.
        self.resolver = resolver
        if resolver is not None and hasattr(self.codec, "set_stage2_resolver"):
            self.codec.set_stage2_resolver(resolver)

    # ------------------------------------------------------------------
    # buffer access
    # ------------------------------------------------------------------

    def _buffer(self, start_byte: int, end_byte: int) -> Tuple[bytes, int]:
        """Return (buffer, base_byte). Zero-copy for in-memory sources."""
        whole = self.reader.view()
        if whole is not None:
            return whole, 0
        end_byte = min(end_byte, self.file_size)
        return self.reader.pread(start_byte, end_byte - start_byte), start_byte

    # ------------------------------------------------------------------
    # generic cache/in-flight plumbing
    # ------------------------------------------------------------------

    def _cache_lookup(self, key):
        # Traced misses leave a zero-duration marker span: the probe itself
        # is a dict access with nothing to time — what matters in a trace is
        # *where* the miss happened (the fetch or in-flight wait that
        # follows shows up as a sibling span with the real duration). Hits
        # record nothing at all: a warm pread probes the cache once per
        # chunk it touches, and any per-probe work here (a live span, even
        # one clock read) was the dominant per-byte tracing overhead.
        val = self._cache_lookup_raw(key)
        if val is None and _obs_trace.tracing_enabled():
            _obs_trace.record_span(
                "fetcher.cache_lookup",
                _time.perf_counter(),
                0.0,
                {"kind": key[0], "key": str(key[1]), "hit": False},
            )
        return val

    def _cache_lookup_raw(self, key):
        # One logical lookup, exactly one hit or miss fleet-wide: the access
        # probe suppresses its miss so a prefetch hit right after is not also
        # counted as an access miss (that skew deflated the aggregated
        # hit-rate in service/metrics.py). Feature-detected: a duck-typed
        # injected cache without lookup() keeps the old double-count
        # behavior rather than breaking.
        lookup = getattr(self.access_cache, "lookup", None)
        if lookup is not None:
            val = lookup(key, record_miss=False)
        else:
            val = self.access_cache.get(key)
        if val is not None:
            return val
        val = self.prefetch_cache.get(key)  # owns the hit-or-miss record
        if val is not None:
            # Promote with the recompute-cost hint intact, or the access
            # tier would rank an expensive marker-mode chunk as cheaply
            # evictable as a zlib-delegable one.
            self._insert_hinted(self.access_cache, key, val,
                                recompute_cost=self._value_cost(val))
        return val

    def _pool_submit(self, fn, *args, cost: Optional[int], priority: bool) -> Future:
        """Submit to the executor, forwarding scheduling hints when it is
        hint-aware (the service layer's TenantExecutor); a plain
        ThreadPoolExecutor gets the vanilla submit."""
        submit_hinted = getattr(self.pool, "submit_hinted", None)
        if submit_hinted is not None:
            return submit_hinted(fn, *args, cost=cost, priority=priority)
        return self.pool.submit(fn, *args)

    def _boost(self, fut: Future) -> None:
        """Upgrade an already-queued task to the priority lane (no-op for
        executors without lanes)."""
        boost = getattr(self.pool, "boost", None)
        if boost is not None:
            boost(fut)

    def _live_inflight_locked(self, key) -> Optional[Future]:
        """In-flight future for ``key``, purging cancelled leftovers.

        A queued task can be cancelled out from under the fetcher (gateway
        client disconnects sweep the batch lane; executor shutdown cancels
        everything). A cancelled task never runs ``_run_task``, so its dedup
        entry would otherwise pin a dead future forever — every later read
        of that chunk would join it and raise CancelledError.
        """
        fut = self._in_flight.get(key)
        if fut is not None and fut.cancelled():
            self._in_flight.pop(key, None)
            return None
        return fut

    def _submit(self, key, fn, *args, cost: Optional[int] = None, priority: bool = False) -> Future:
        with self._lock:
            fut = self._live_inflight_locked(key)
            if fut is not None:
                if priority:
                    # An interactive read joined an already-queued batch task
                    # (typically its own earlier prefetch): upgrade its lane
                    # or the dedup would quietly drop the priority hint.
                    self._boost(fut)
                return fut
            # Carry the submitter's trace context explicitly: a plain
            # ThreadPoolExecutor does not propagate it (the service-layer
            # FairExecutor does, and _run_task defers to it when so).
            fut = self._pool_submit(self._run_task, _obs_trace.capture(),
                                    key, fn, *args,
                                    cost=cost, priority=priority)
            self._in_flight[key] = fut
            return fut

    def _blocking_result(self, key, fn, *args, cost: Optional[int] = None):
        """Submit-and-wait with cancellation resilience: if the future we
        joined was cancelled while queued (disconnect sweep racing a dedup),
        re-submit instead of failing the innocent read — unless this fetcher
        is shutting down, in which case the cancellation IS the shutdown's
        own sweep and resubmitting would run a task against the closing
        reader (a shared executor happily accepts submissions after a
        view-scoped cancel; only the fetcher knows its reader is dying)."""
        while True:
            fut = self._submit(key, fn, *args, cost=cost, priority=True)
            try:
                return fut.result()
            except CancelledError:
                if self._closed:
                    raise
                with self._lock:
                    self._live_inflight_locked(key)  # purge the dead entry
                continue

    def _insert_hinted(self, cache, key, value, recompute_cost: int) -> None:
        """Cache insert carrying a recompute-cost hint when supported."""
        insert_hinted = getattr(cache, "insert_hinted", None)
        if insert_hinted is not None:
            insert_hinted(key, value, recompute_cost=recompute_cost)
        else:
            cache.insert(key, value)

    def _value_cost(self, value) -> int:
        """Recompute-cost estimate for an arbitrary cached value."""
        if isinstance(value, DecodeResult):
            return self._result_cost(value)
        nbytes = getattr(value, "nbytes", None)
        if nbytes is not None:
            return max(1, int(nbytes))
        try:
            return max(1, len(value))
        except TypeError:
            return 1

    def _run_task(self, ctx, key, fn, *args):
        try:
            if not _obs_trace.tracing_enabled():
                return fn(*args)
            # FairExecutor workers already reinstated the submitter's context
            # (and opened an executor.run span we should nest under); only a
            # bare pool needs the carried context attached here.
            attach_ctx = ctx if _obs_trace.current_context() is None else None
            with _obs_trace.attach(attach_ctx), _obs_trace.span(
                "fetcher.task", {"kind": key[0], "key": str(key[1])}
            ):
                return fn(*args)
        finally:
            with self._lock:
                self._in_flight.pop(key, None)

    # ------------------------------------------------------------------
    # first pass (no index): speculative parallel decompression
    # ------------------------------------------------------------------

    def nominal_index_of(self, bit_offset: int) -> int:
        return min(bit_offset // (self.chunk_size * 8), self.n_nominal - 1)

    def _nominal_stop_bit(self, k: int) -> int:
        return min((k + 1) * self.chunk_size * 8, self.total_bits)

    # Cost model for scheduling hints (estimated bytes of decompression
    # work): marker-mode two-stage decode costs >2x a zlib delegation over
    # the same span (paper §1.3) — charge it 2x the chunk size.
    MARKER_COST_FACTOR = 2

    def _nominal_cost(self) -> int:
        return self.MARKER_COST_FACTOR * self.chunk_size

    def _result_cost(self, result: DecodeResult) -> int:
        """Recompute cost of a first-pass chunk result: marker-mode chunks
        need the full two-stage pipeline again (decode + replacement);
        window-known chunks only a single custom-decoder pass."""
        factor = 1 + self.MARKER_COST_FACTOR if result.marker_mode else self.MARKER_COST_FACTOR
        return factor * max(1, result.size)

    def trigger_prefetch(self, k: int) -> None:
        """Dispatch speculative tasks per the prefetch strategy (paper §3.1:
        access triggers the prefetcher even on a cache hit). Prefetches ride
        the batch lane: they must never delay any tenant's blocking read."""
        with self._strategy_lock:
            targets = self.strategy.on_access(k)
        for j in targets:
            if j < 0 or j >= self.n_nominal:
                continue
            with self._lock:
                if j in self._nominal_done or self._live_inflight_locked(("nom", j)) is not None:
                    continue
            self._submit(
                ("nom", j), self._task_nominal, j,
                cost=self._nominal_cost(), priority=False,
            )

    def get_chunk_at(self, bit_offset: int, window: Optional[bytes] = None) -> DecodeResult:
        """Fetch the chunk starting exactly at ``bit_offset`` (first pass).

        ``window`` may carry a known window (e.g. b"" right after a gzip
        header) enabling single-stage decode; None means two-stage marker
        mode.
        """
        k = self.nominal_index_of(bit_offset)
        self.trigger_prefetch(k)

        key = ("fp", bit_offset)
        res = self._cache_lookup(key)
        if res is not None:
            # Marker-mode results are fine even when the window is known:
            # finalize_async resolves them with the supplied window.
            return res

        # A nominal prefetch covering this offset may be in flight — its
        # result is only usable if its speculative start matched exactly.
        with self._lock:
            nom_fut = self._live_inflight_locked(("nom", k))
        if nom_fut is not None:
            # About to block an interactive read on it: pull it out of the
            # batch backlog (same inversion _submit's dedup path fixes).
            self._boost(nom_fut)
            try:
                nom_res = nom_fut.result()
            except CancelledError:
                # Swept by a disconnect between our lookup and the boost:
                # fall through to a fresh exact task, like any other miss.
                nom_res = None
            if nom_res is not None and nom_res.start_bit == bit_offset:
                return nom_res
            with self._lock:
                self.stats.redispatches += 1

        # The caller blocks on this task: interactive lane, so it bypasses
        # this tenant's own queued prefetch backlog. Known window -> single
        # stage; unknown -> marker mode at 2x cost.
        cost = self.chunk_size if window is not None else self._nominal_cost()
        res = self._blocking_result(key, self._task_exact, bit_offset, window,
                                    cost=cost)
        if res is None:
            raise RapidgzipError("exact chunk decode failed at bit %d" % bit_offset)
        return res

    # -- tasks ----------------------------------------------------------

    def _margins(self, start_byte: int, stop_byte: int):
        """Yield growing (buffer, base) windows until EOF is covered."""
        margin = max(2 * self.chunk_size, 1 << 20)
        while True:
            end = min(stop_byte + margin, self.file_size)
            yield self._buffer(start_byte, end), end >= self.file_size
            if end >= self.file_size:
                return
            margin *= 4

    def _task_nominal(self, k: int) -> Optional[DecodeResult]:
        if not self.codec.supports_speculation:
            # Exact-index codecs (BGZF, zstd) never speculate: the reader
            # builds a finalized index before any read, so a stray nominal
            # dispatch just records "nothing found" without touching stats.
            with self._lock:
                self._nominal_done[k] = None
            return None
        with self._lock:
            self.stats.nominal_tasks += 1
        start_bit = k * self.chunk_size * 8
        stop_bit = self._nominal_stop_bit(k)
        if start_bit >= self.total_bits:
            with self._lock:
                self._nominal_done[k] = None
            return None

        failed: set = set()
        result: Optional[DecodeResult] = None
        for (buf, base), at_eof in self._margins(start_bit // 8, stop_bit // 8):
            base_bits = base * 8
            local_start = start_bit - base_bits
            local_stop = stop_bit - base_bits
            need_more_data = False
            for cand in self.codec.find_chunk_starts(buf, local_start, local_stop):
                if cand + base_bits in failed:
                    continue
                with self._lock:
                    self.stats.candidates_tried += 1
                try:
                    res = self.codec.decode_chunk(
                        buf,
                        cand,
                        local_stop,
                        window=None,
                        max_out=self.max_ratio * self.chunk_size,
                    )
                except EndOfStream:
                    if not at_eof:
                        need_more_data = True
                        break
                    with self._lock:
                        self.stats.false_positive_starts += 1
                    failed.add(cand + base_bits)
                    continue
                except DeflateError:
                    with self._lock:
                        self.stats.false_positive_starts += 1
                    failed.add(cand + base_bits)
                    continue
                result = _offset_result(res, base_bits)
                break
            if result is not None or not need_more_data:
                break

        with self._lock:
            self._nominal_done[k] = result.start_bit if result is not None else None
        if result is not None:
            self._insert_hinted(
                self.prefetch_cache, ("fp", result.start_bit), result,
                recompute_cost=self._result_cost(result),
            )
            with self._lock:
                if result.contains_markers():
                    self.stats.chunks_with_markers += 1
        return result

    def _task_exact(self, bit_offset: int, window: Optional[bytes]) -> DecodeResult:
        with self._lock:
            self.stats.exact_tasks += 1
        k = self.nominal_index_of(bit_offset)
        stop_bit = max(self._nominal_stop_bit(k), bit_offset + 1)
        last_err: Optional[Exception] = None
        for (buf, base), at_eof in self._margins(bit_offset // 8, stop_bit // 8):
            base_bits = base * 8
            try:
                res = self.codec.decode_chunk(
                    buf,
                    bit_offset - base_bits,
                    stop_bit - base_bits,
                    window=window,
                    max_out=self.max_ratio * self.chunk_size,
                )
            except EndOfStream as exc:
                if not at_eof:
                    last_err = exc
                    continue
                raise
            res = _offset_result(res, base_bits)
            self._insert_hinted(
                self.prefetch_cache, ("fp", bit_offset), res,
                recompute_cost=self._result_cost(res),
            )
            with self._lock:
                self._nominal_done.setdefault(k, res.start_bit)
                if res.contains_markers():
                    self.stats.chunks_with_markers += 1
            return res
        raise last_err  # pragma: no cover - loop always ends at EOF

    # ------------------------------------------------------------------
    # finalization (stage 2)
    # ------------------------------------------------------------------

    def finalize_async(
        self, result: DecodeResult, window: Optional[bytes], out_start: int
    ) -> FinalizedChunk:
        """Propagate the window (sequential, O(32 KiB)) and dispatch full
        marker replacement to the pool."""
        window_out = self.codec.propagate_window(result.data, window)
        fc = FinalizedChunk(
            start_bit=result.start_bit,
            end_bit=result.end_bit,
            out_start=out_start,
            size=result.size,
            window_in=window,
            window_out=window_out,
            result=result,
        )
        fc._crc32 = self.crc32
        if result.marker_mode:
            # Replacement sits on the read critical path (the caller's
            # bytes() blocks on it): interactive lane, cost ~ one linear
            # pass over the chunk's output.
            fc._bytes_future = self._pool_submit(
                self._task_replace, result, window,
                cost=max(1, result.size), priority=True,
            )
        else:
            fc._bytes = result.data
        with self._lock:
            self.stats.bytes_decompressed += result.size
        return fc

    def _task_replace(self, result: DecodeResult, window: Optional[bytes]) -> np.ndarray:
        if not result.contains_markers():
            return result.data.astype(np.uint8)
        if self.resolver is not None:
            # Direct submission (not via the codec shim): many pool workers
            # hit this concurrently and the engine coalesces their chunks
            # into one batched device dispatch.
            return self.resolver.replace_markers(result.data, window)
        return self.codec.replace_markers(result.data, window)

    def crc32(self, data) -> int:
        """CRC32 through the stage-2 resolver when present, zlib otherwise.

        Accepts bytes or a uint8 ndarray (reader verification passes array
        segments straight through).
        """
        if self.resolver is not None:
            return self.resolver.crc32(data)
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        return _zlib.crc32(data) & 0xFFFFFFFF

    # ------------------------------------------------------------------
    # indexed mode (second pass / imported index / BGZF)
    # ------------------------------------------------------------------

    def _indexed_cost(self, i: int) -> int:
        out_size = self.index.chunk_output_size(i)
        return out_size if out_size else self.chunk_size

    def get_indexed(self, i: int) -> np.ndarray:
        """Decompressed bytes of index chunk ``i`` (seek point i .. i+1)."""
        with self._strategy_lock:
            targets = self.strategy.on_access(i)
        for j in targets:
            if 0 <= j < len(self.index) and self.index.chunk_output_size(j) is not None:
                with self._lock:
                    if self._live_inflight_locked(("ix", j)) is not None:
                        continue
                if ("ix", j) in self.prefetch_cache or ("ix", j) in self.access_cache:
                    continue
                self._submit(("ix", j), self._task_indexed, j,
                             cost=self._indexed_cost(j), priority=False)

        key = ("ix", i)
        val = self._cache_lookup(key)
        if val is not None:
            return val
        # Blocking fetch: interactive lane (jumps this tenant's prefetches),
        # resilient to a disconnect sweep cancelling the future it joined.
        return self._blocking_result(key, self._task_indexed, i,
                                     cost=self._indexed_cost(i))

    def put_indexed(self, i: int, data: np.ndarray) -> None:
        """Install first-pass bytes under their index key (frontier handoff).

        Goes to the prefetch cache (2x parallelism entries): the access cache
        may be sized 1 and a chunk can hand over several split slices.
        """
        self._insert_hinted(self.prefetch_cache, ("ix", i), data,
                            recompute_cost=int(data.nbytes))

    def _task_indexed(self, i: int) -> np.ndarray:
        with self._lock:
            self.stats.indexed_tasks += 1
        point = self.index.point_at(i)
        out_size = self.index.chunk_output_size(i)
        if out_size is None:
            raise RapidgzipError("indexed chunk %d has unknown size" % i)
        if out_size == 0:
            return np.empty(0, dtype=np.uint8)
        start_byte = point.compressed_bit // 8
        if i + 1 < len(self.index):
            comp_span = self.index.point_at(i + 1).compressed_bit // 8 - start_byte
        else:
            comp_span = self.file_size - start_byte
        buf, base = self._buffer(start_byte, start_byte + comp_span + (1 << 16))
        local_bit = point.compressed_bit - base * 8
        if i + 1 < len(self.index):
            local_stop = self.index.point_at(i + 1).compressed_bit - base * 8
        else:
            local_stop = len(buf) * 8

        if point.flags & self.codec.decoder_required_flags:
            # Deflate: a gzip member boundary inside the chunk (zlib raw
            # streams cannot cross it) or stored-block padding that would
            # not survive the bit-shift realignment — use the codec's own
            # decoder (window known -> single stage). Codecs whose delegate
            # always works declare an empty mask and never take this branch.
            res = self.codec.decode_chunk(
                buf,
                local_bit,
                local_stop,
                window=point.window if point.window is not None else b"",
                max_out=out_size + self.codec.window_size,
            )
            data = res.data[:out_size]
            if data.shape[0] < out_size:
                raise DeflateError("indexed chunk %d produced too few bytes" % i)
            # Custom-decoder path: ~2x the recompute cost of a delegation.
            self._insert_hinted(self.prefetch_cache, ("ix", i), data,
                                recompute_cost=self.MARKER_COST_FACTOR * out_size)
            return data

        with self._lock:
            # Historical stats name, kept across codecs: "delegation" = the
            # native-library fast path (zlib for deflate, zstd for zstd).
            self.stats.zlib_delegations += 1
        raw = self.codec.delegate(
            buf, local_bit, point.window or b"", out_size,
            # +2 bytes slack: enough for the final block's bit tail, not
            # enough for zlib to parse a (shift-broken) stored header beyond
            # the chunk boundary.
            max_input_bytes=comp_span + 2,
        )
        data = np.frombuffer(raw, dtype=np.uint8)
        # zlib-delegable: the cheapest entry class in the pool — recompute
        # is a single delegation over out_size bytes.
        self._insert_hinted(self.prefetch_cache, ("ix", i), data,
                            recompute_cost=out_size)
        return data

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        self._closed = True  # before the sweep: see _blocking_result
        if self._owns_executor:
            self.pool.shutdown(wait=False, cancel_futures=True)
        else:
            # Externally owned executor: never shut it down, but drop our own
            # queued tasks if the executor offers a scoped cancel (the
            # service layer's TenantExecutor view does) — otherwise stale
            # prefetches would run against a closing reader.
            cancel_pending = getattr(self.pool, "cancel_pending", None)
            if cancel_pending is not None:
                cancel_pending()
        # Injected caches may outlive this fetcher inside a shared pool;
        # release() deregisters them and returns their bytes to the budget.
        for cache in (self.access_cache, self.prefetch_cache):
            release = getattr(cache, "release", None)
            if release is not None:
                release()

    def cache_report(self) -> dict:
        def stats_of(cache) -> dict:
            # Same duck-typed contract as the lookup/insert hooks: a cache
            # without the atomic snapshot() still reports via .stats.
            snapshot = getattr(cache, "snapshot", None)
            if snapshot is not None:
                return snapshot()["stats"].as_dict()
            return cache.stats.as_dict()

        return {
            "access": stats_of(self.access_cache),
            "prefetch": stats_of(self.prefetch_cache),
            "fetcher": self.stats.as_dict(),
        }


#: Historical name from when the fetcher was deflate-only; the class has
#: been codec-parameterized (``codec=`` kwarg) but the default construction
#: is unchanged, so existing callers keep working.
GzipChunkFetcher = ChunkFetcher


def _offset_result(res: DecodeResult, base_bits: int) -> DecodeResult:
    """Translate a buffer-local DecodeResult to global bit offsets."""
    if base_bits == 0:
        return res
    res.start_bit += base_bits
    res.end_bit += base_bits
    for b in res.blocks:
        b.bit_offset += base_bits
    for me in res.member_ends:
        me.footer_end_bit += base_bits
    for ms in res.member_starts:
        ms.header_start_bit += base_bits
        ms.deflate_start_bit += base_bits
    return res
