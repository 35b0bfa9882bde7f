"""ParallelGzipReader — seekable, parallel-decompressing file-like object
(paper §3.1, Fig 4/5).

Reading drives a *frontier* of sequential finalization over parallel
speculative chunk decompression:

  * ``read``/``seek`` only update the logical position (a seek does no work
    until the next read — paper §3.1).
  * Positions beyond the finalized frontier advance it: prefetched chunks are
    fetched from the cache (dispatching exact re-decodes on speculation
    misses), their windows propagated sequentially, marker replacement and
    CRC parts dispatched to the pool, and seek points appended to the
    on-the-fly index — including interior split points that bound the
    decompressed spacing (load balancing for the indexed pass, paper §1.4).
  * Positions behind the frontier are served through the seek-point index:
    O(1) to the chunk, zlib-delegated decompression, adaptive prefetch for
    sequential patterns.
  * BGZF files are detected and indexed directly from their metadata — the
    trivially-parallel fast path (paper §3.4.4).

The index can be exported/imported; with an imported index the first pass is
skipped entirely and every read is an indexed read (paper Fig 9 "with
index").

Concurrency contract: ``pread(offset, size)`` is a *stateless* positional
read — no shared cursor, safe from any number of threads at once. Ranges
already covered by the index are served with no reader-level lock at all
(index lookups and chunk fetches are thread-safe on their own); only
advancing the speculative first pass is serialized, behind a narrow
*frontier lock* taken one chunk at a time. ``read``/``seek``/``tell`` keep
the classic file-object cursor and are only safe from one thread, but they
ride the same machinery, so a cursor reader and many pread callers can share
one instance.
"""

from __future__ import annotations

import io
import threading
import time as _time
import zlib as _zlib
from typing import List, Optional, Union

import numpy as np

from ..obs import trace as _obs_trace
from .chunk_fetcher import FinalizedChunk, ChunkFetcher
from .codec import Codec, DeflateCodec, detect_codec, resolve_codec
from .crc32 import crc32_combine
from .deflate import BT_FIXED
from .errors import FormatError, GzipFooterError, RapidgzipError
from .filereader import open_file_reader
from .index import (
    FLAG_HAS_INTERIOR_MEMBER_END,
    FLAG_ZLIB_UNSAFE,
    GzipIndex,
    SeekPoint,
)
from .markers import full_window

#: A pread nested under a service span records its own ring entry only when
#: it ran at least this long: below it, the read was served from cache and
#: its interval is already covered by the parent span. Reads that did real
#: work clear the floor comfortably — decompressing even one cold chunk
#: takes multiple milliseconds, a remote range-GET tens of ms.
_NESTED_PREAD_RECORD_S = 5e-4


class ParallelGzipReader(io.RawIOBase):
    """File-like object exposing the decompressed stream of a gzip file."""

    def __init__(
        self,
        source,
        *,
        parallelization: int = 4,
        chunk_size: int = 4 << 20,
        index: Optional[Union[GzipIndex, str, bytes]] = None,
        verify: bool = True,
        framing: str = "gzip",
        codec: Union[None, str, Codec] = None,
        index_spacing: Optional[int] = None,
        access_cache_size: int = 1,
        executor=None,
        access_cache=None,
        prefetch_cache=None,
        prefetch_strategy=None,
        resolver=None,
        device: str = "cuda",
    ):
        super().__init__()
        if resolver is None:
            # Stage 2 runs on the card unless the caller asks for the CPU:
            # one process-wide engine per device (kernels/engine.py).
            from ..kernels.engine import shared_engine

            resolver = shared_engine(device)
        self._reader = open_file_reader(source)
        try:
            self._verify = verify
            self._framing = framing
            # Decompressed spacing between seek points; chunks whose
            # decompressed size exceeds it are split at interior block
            # boundaries (paper §1.4).
            self._index_spacing = index_spacing or 4 * chunk_size

            if isinstance(index, str):
                index = GzipIndex.import_file(index)
            elif isinstance(index, (bytes, bytearray)):
                index = GzipIndex.from_bytes(bytes(index))

            # Codec resolution, cheapest evidence first: an explicit
            # instance/tag wins; raw framing is deflate by definition; a
            # finalized imported index names its own codec (no head read —
            # remote sources skip a round trip); otherwise probe the head
            # bytes (BGZF before gzip before the deflate fallback — valid
            # gzip can never error here, satellite guarantee).
            if isinstance(codec, Codec) or isinstance(codec, str):
                self._codec = resolve_codec(codec, framing=framing)
            elif framing == "raw":
                self._codec = DeflateCodec(framing="raw")
            elif index is not None and index.finalized:
                self._codec = resolve_codec(index.codec_tag)
            else:
                self._codec = detect_codec(self._reader.pread(0, 1 << 12))

            self._fetcher = ChunkFetcher(
                self._reader,
                chunk_size=chunk_size,
                parallelization=parallelization,
                framing=framing,
                codec=self._codec,
                index=index,
                access_cache_size=access_cache_size,
                executor=executor,
                access_cache=access_cache,
                prefetch_cache=prefetch_cache,
                prefetch_strategy=prefetch_strategy,
                resolver=resolver,
            )
            self._index = self._fetcher.index

            self._pos = 0
            self._eos = False
            self._frontier_bit = 0
            self._frontier_out = 0
            self._window: Optional[bytes] = b""
            self._member_crc = 0
            self._member_len = 0
            # Serializes first-pass advancement; indexed reads never take it.
            self._frontier_lock = threading.Lock()
            self._frontier_acquires = 0
            self._frontier_contended = 0
            self._frontier_wait_s = 0.0

            if self._index.finalized:
                # Imported index: no first pass needed.
                self._eos = True
                self._frontier_out = self._index.decompressed_size or 0
            elif self._build_exact_index():
                # Metadata-only index (BGZF member walk, zstd seek table):
                # the trivially-parallel path — zero speculative decoding.
                self._eos = True
                self._frontier_out = self._index.decompressed_size or 0
            else:
                self._frontier_bit = self._codec.leading_header_bits(self._reader)
        except BaseException:
            # A half-built reader must not leak: header parsing or index
            # import raising here would otherwise strand the opened
            # FileReader (an FD, or remote connections) and — when the
            # fetcher was already constructed — leave pooled caches and the
            # executor view registered against shared service budgets.
            try:
                fetcher = getattr(self, "_fetcher", None)
                if fetcher is not None:
                    fetcher.shutdown()
                else:
                    # The fetcher would have owned releasing the injected
                    # caches; it never existed, so release them ourselves.
                    for cache in (access_cache, prefetch_cache):
                        release = getattr(cache, "release", None)
                        if release is not None:
                            release()
            finally:
                self._reader.close()
                # Mark the stream closed so the interpreter's later
                # RawIOBase.__del__ -> close() does not re-run teardown on
                # the half-built object (double cache release / double
                # shutdown).
                super().close()
            raise

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _build_exact_index(self) -> bool:
        """Try the codec's metadata-only index (paper §3.4.4's fast path).

        Built into a scratch index and installed atomically on success: a
        scan failing midway (e.g. a file whose first member is BGZF but
        whose later members are plain gzip) must leave the shared index
        untouched, because its partial points would poison the speculative
        pass's on-the-fly `add_point` ordering. On such a failure a codec
        that supports speculation falls back to it — valid gzip never
        errors out of auto-detection.
        """
        tmp = GzipIndex(codec_tag=self._codec.tag)
        try:
            if not self._codec.build_exact_index(self._reader, tmp):
                return False
        except FormatError:
            if self._codec.supports_speculation:
                return False
            raise
        for p in tmp.points():
            self._index.add_point(p)
        self._index.finalize(tmp.decompressed_size or 0, tmp.compressed_size or 0)
        return True

    # ------------------------------------------------------------------
    # frontier: first-pass parallel decompression + on-the-fly indexing
    # ------------------------------------------------------------------

    def _advance_frontier(self) -> None:
        """Advance the first pass by one chunk. Callers other than the
        constructor must hold ``_frontier_lock`` — this mutates the window,
        CRC running state, and the frontier offsets."""
        if self._eos:
            return
        with _obs_trace.span("reader.chunk_wait"):
            res = self._fetcher.get_chunk_at(self._frontier_bit, window=self._window)
        fc = self._fetcher.finalize_async(res, self._window, self._frontier_out)
        self._collect(fc)
        self._window = fc.window_out
        self._frontier_bit = res.end_bit
        self._frontier_out += res.size
        if res.ended_at_eos:
            # Finalize the index *before* publishing EOS: lock-free pread
            # callers treat `_eos` as "the index now answers everything" —
            # seeing it early would turn an in-range read into a short one.
            self._index.finalize(self._frontier_out, self._reader.size())
            self._eos = True

    def _advance_frontier_past(self, pos: int) -> None:
        """Take the frontier lock and advance the first pass one chunk,
        unless a concurrent caller already made ``pos`` serveable. One chunk
        per acquisition keeps the critical section narrow: concurrent
        readers waiting on different offsets interleave instead of one
        caller holding the lock across a long catch-up."""
        # Span covers lock wait + the one-chunk advance: in a trace of a
        # cold read this is the "frontier wait" row (first-pass work other
        # readers may be doing on our behalf shows up as sibling spans).
        with _obs_trace.span("reader.frontier_wait"):
            if self._frontier_lock.acquire(blocking=False):
                self._frontier_acquires += 1
            else:
                t0 = _time.perf_counter()
                self._frontier_lock.acquire()
                # Counters are only mutated while holding the frontier lock,
                # so plain int/float updates are race-free; readers may see a
                # slightly stale snapshot, which telemetry tolerates.
                self._frontier_acquires += 1
                self._frontier_contended += 1
                self._frontier_wait_s += _time.perf_counter() - t0
            try:
                if not self._eos and self._serveable_point(pos) is None:
                    self._advance_frontier()
            finally:
                self._frontier_lock.release()

    def _collect(self, fc: FinalizedChunk) -> None:
        """Sequential bookkeeping for one finalized chunk: CRC verification,
        seek points (with interior splits), and byte handoff to the cache."""
        data = fc.bytes()
        res = fc.result

        # -- CRC32 / ISIZE verification at member ends ---------------------
        if self._verify and self._codec.verifies_members:
            with _obs_trace.span("reader.verify"):
                prev = 0
                for me in res.member_ends:
                    seg = data[prev : me.out_offset]
                    crc = self._fetcher.crc32(seg)
                    self._member_crc = crc32_combine(self._member_crc, crc, int(seg.shape[0]))
                    self._member_len += int(seg.shape[0])
                    if self._member_crc != me.crc32:
                        raise GzipFooterError(
                            "CRC32 mismatch at decompressed offset %d"
                            % (fc.out_start + me.out_offset)
                        )
                    if (self._member_len & 0xFFFFFFFF) != me.isize:
                        raise GzipFooterError("ISIZE mismatch")
                    self._member_crc = 0
                    self._member_len = 0
                    prev = me.out_offset
                tail = data[prev:]
                if tail.shape[0]:
                    crc = self._fetcher.crc32(tail)
                    self._member_crc = crc32_combine(self._member_crc, crc, int(tail.shape[0]))
                    self._member_len += int(tail.shape[0])

        # -- seek points ----------------------------------------------------
        cuts = self._split_offsets(fc)
        self._observe_chunk(res, cuts)
        first_bound = cuts[0][1] if cuts else fc.size
        point_flags = 0
        if any(0 < me.out_offset <= first_bound for me in res.member_ends):
            point_flags |= FLAG_HAS_INTERIOR_MEMBER_END
        starts = [(fc.start_bit, 0, point_flags)] + cuts
        bounds_for_flags = [s[1] for s in starts] + [fc.size]
        stored_offsets = self._codec.stored_block_offsets(res)
        ordinals: List[int] = []
        for j, (bit, local_out, flags) in enumerate(starts):
            # zlib delegation is unsafe when stored-block padding would not
            # survive the bit-shift realignment (see FLAG_ZLIB_UNSAFE).
            if bit % 8 != 0:
                lo, hi = local_out, bounds_for_flags[j + 1]
                if any(lo <= so < hi for so in stored_offsets):
                    flags |= FLAG_ZLIB_UNSAFE
            window = self._window_at(fc, local_out)
            self._index.add_point(SeekPoint(bit, fc.out_start + local_out, window, flags))
            ordinals.append(len(self._index) - 1)
        # Hand decompressed slices to the cache under their index keys so
        # trailing reads are free.
        bounds = [s[1] for s in starts] + [fc.size]
        for j, i_point in enumerate(ordinals):
            self._fetcher.put_indexed(i_point, data[bounds[j] : bounds[j + 1]])

    def _observe_chunk(self, res, cuts) -> None:
        """Record first-pass hostility observations on the in-memory index
        (``Codec.seek_hostility`` scores them once the index finalizes).
        Runs under the frontier lock, so plain dict updates are race-free."""
        obs = self._index.observations
        obs["chunks"] = obs.get("chunks", 0) + 1
        if res.marker_mode:
            obs["marker_chunks"] = obs.get("marker_chunks", 0) + 1
        if res.blocks and all(b.block_type == BT_FIXED for b in res.blocks):
            obs["fixed_chunks"] = obs.get("fixed_chunks", 0) + 1
        obs["split_points"] = obs.get("split_points", 0) + len(cuts)

    def _split_offsets(self, fc: FinalizedChunk):
        """Interior seek points bounding decompressed spacing (paper §1.4)."""
        res = fc.result
        cuts = []
        if fc.size <= self._index_spacing:
            return cuts
        next_cut = self._index_spacing
        for b in res.blocks[1:]:
            if b.out_offset < next_cut or b.is_final:
                continue
            cand = self._codec.split_candidate(b)
            if cand is None:
                continue  # the finder cannot resume at this block type
            bit, flags = cand
            # Member-boundary flag for the sub-chunk starting here.
            lo = b.out_offset
            hi = fc.size
            if any(lo < me.out_offset <= hi for me in res.member_ends):
                flags |= FLAG_HAS_INTERIOR_MEMBER_END
            cuts.append((bit, b.out_offset, flags))
            next_cut = b.out_offset + self._index_spacing
        # Fix member-end flags of earlier pieces: a piece has the flag iff a
        # member end falls strictly inside (start, next_start].
        fixed = []
        all_bounds = [c[1] for c in cuts] + [fc.size]
        for j, (bit, off, flags) in enumerate(cuts):
            lo, hi = off, all_bounds[j + 1]
            has = any(lo < me.out_offset <= hi for me in res.member_ends)
            flags = (flags | FLAG_HAS_INTERIOR_MEMBER_END) if has else (flags & ~FLAG_HAS_INTERIOR_MEMBER_END)
            fixed.append((bit, off, flags))
        return fixed

    def _window_at(self, fc: FinalizedChunk, local_out: int) -> bytes:
        wsize = self._codec.window_size
        if local_out == 0 or wsize == 0:
            return self._window if self._window is not None else b""
        data = fc.bytes()
        if local_out >= wsize:
            return data[local_out - wsize : local_out].tobytes()
        prev = full_window(self._window)
        combined = np.concatenate([prev, data[:local_out]])
        return combined[-wsize:].tobytes()

    # ------------------------------------------------------------------
    # io.RawIOBase interface
    # ------------------------------------------------------------------

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            pos = offset
        elif whence == io.SEEK_CUR:
            pos = self._pos + offset
        elif whence == io.SEEK_END:
            pos = self.size() + offset
        else:
            raise ValueError("bad whence")
        if pos < 0:
            raise ValueError("negative seek position")
        self._pos = pos  # lazy: work happens on the next read (paper §3.1)
        return pos

    def size(self) -> int:
        """Decompressed size (drives the first pass to completion)."""
        while not self._eos:
            # frontier_out is never serveable pre-EOS, so each call advances
            # exactly one chunk (and concurrent callers share the work).
            self._advance_frontier_past(self._frontier_out)
        assert self._index.decompressed_size is not None
        return self._index.decompressed_size

    def _serveable_point(self, pos: int) -> Optional[int]:
        """Ordinal of the seek point that can serve ``pos`` through an
        indexed fetch *right now*, or None while the first pass must advance
        (or, at EOS, when ``pos`` is at/past the end of the stream)."""
        if pos >= self._frontier_out:
            return None
        i = self._index.find(pos)
        if i is None:
            raise RapidgzipError("position %d precedes the index" % pos)
        # The chunk's size must be bounded by a successor point (or the
        # finalized total) before an indexed fetch can run.
        if i + 1 >= len(self._index) and not self._index.finalized:
            return None
        return i

    def _read_span(self, pos: int, end: Optional[int]) -> bytes:
        """Decompressed bytes [pos, end) (to EOF when end is None) — the
        shared engine under ``read`` and ``pread``. Stateless: no cursor, no
        lock on the indexed path; the frontier lock only while the first
        pass must advance past uncovered positions."""
        out: List[bytes] = []
        while end is None or pos < end:
            # Snapshot EOS *before* probing: if EOS lands between the probe
            # and the check, the stale False routes us through the (no-op)
            # locked advance and we re-probe under the final index state
            # instead of breaking early with a short read.
            at_eos = self._eos
            i = self._serveable_point(pos)
            if i is None:
                if at_eos:
                    break  # at/past EOF
                self._advance_frontier_past(pos)
                continue
            data = self._fetcher.get_indexed(i)
            start = self._index.point_at(i).decompressed_byte
            off = pos - start
            avail = int(data.shape[0]) - off
            if avail <= 0:
                break  # pos beyond EOF (e.g. a stale index overstating coverage)
            take = avail if end is None else min(avail, end - pos)
            out.append(data[off : off + take].tobytes())
            pos += take
        return b"".join(out)

    def pread(self, offset: int, size: int) -> bytes:
        """Stateless positional read: decompressed [offset, offset+size),
        short at EOF. Thread-safe with no shared cursor — any number of
        threads may pread concurrently; index-covered ranges (always, once
        the index is finalized) are served entirely lock-free."""
        if offset < 0 or size < 0:
            raise ValueError("pread offset and size must be non-negative")
        if not _obs_trace.tracing_enabled():
            # One flag check is the entire disabled-tracing cost on the warm
            # lock-free path (the obs benchmark's "unmeasurable" claim).
            return self._read_span(offset, offset + size)
        if _obs_trace.current_context() is None:
            # Root read (direct reader use, no service boundary above): a
            # live span, so frontier/fetch children nest under it.
            with _obs_trace.span("reader.pread"):
                return self._read_span(offset, offset + size)
        # Nested under a service boundary that already carries this read's
        # offset/size and ~duration (server.read_range, fleet.pread): the
        # parent's span and histogram cover the interval, so a fast read
        # here records nothing of its own — a live Span (or even one
        # histogram observe) per warm cache hit was most of the
        # enabled-tracing overhead the obs benchmark bounds at 5%. Only a
        # read slow enough to say something the parent does not (it did
        # first-pass or fetch work) lands in the ring and the histogram.
        t0 = _time.perf_counter()
        try:
            return self._read_span(offset, offset + size)
        finally:
            dur = _time.perf_counter() - t0
            if dur >= _NESTED_PREAD_RECORD_S:
                # record_span feeds the histogram itself.
                _obs_trace.record_span("reader.pread", t0, dur)

    def read(self, size: int = -1) -> bytes:
        data = self._read_span(self._pos, None if size < 0 else self._pos + size)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def cancel_prefetches(self) -> int:
        """Cancel this reader's *queued* batch-lane prefetch tasks.

        Used when the consumer that motivated the speculation is gone (a
        gateway client disconnecting mid-stream): queued prefetches are pure
        latency-hiding — dropping them frees executor bandwidth without
        affecting correctness, and the fetcher's dedup map resubmits on the
        next demand fetch. Priority-lane tasks (a live read is blocking on
        them) are never touched. Returns the number cancelled; 0 for plain
        executors without a scoped cancel.
        """
        cancel_pending = getattr(self._fetcher.pool, "cancel_pending", None)
        if cancel_pending is None:
            return 0
        try:
            return cancel_pending(batch_only=True)
        except TypeError:  # a duck-typed view without the kwarg
            return 0

    def close(self) -> None:
        if not self.closed:
            try:
                self._fetcher.shutdown()
            finally:
                # The file handle (and any remote connections) must close
                # even when a cache release / task cancel raises mid-shutdown.
                self._reader.close()
        super().close()

    # ------------------------------------------------------------------
    # index import/export & introspection
    # ------------------------------------------------------------------

    @property
    def index(self) -> GzipIndex:
        return self._index

    @property
    def codec(self) -> Codec:
        return self._codec

    def build_full_index(self) -> GzipIndex:
        self.size()  # drives the first pass to completion (frontier-locked)
        return self._index

    def seek_hostility(self) -> float:
        """The codec's seek-hostility score for this reader's index (0 when
        the first pass has not finished — only a fully built index can be
        judged)."""
        if not self._index.finalized:
            return 0.0
        return self._codec.seek_hostility(self._index)

    def export_index(self, dest) -> None:
        self.build_full_index()
        self._index.export_file(dest)

    def stats(self) -> dict:
        report = self._fetcher.cache_report()
        report["frontier"] = {
            "lock_acquires": int(self._frontier_acquires),
            "lock_contended": int(self._frontier_contended),
            "lock_wait_s": float(self._frontier_wait_s),
        }
        return report
