"""RemoteFileReader — stateless HTTP(S) range-GET preads (paper §3, Fig 5).

The paper hides all file access behind the ``FileReader`` pread abstraction
precisely so the cache + prefetcher + thread pool can serve *any* byte
source. This module is that promise cashed in for remote objects: every
``pread`` maps to an HTTP ``Range: bytes=a-b`` request, so the service layer
can decompress and seek inside archives it never fully downloads.

Why the architecture transfers (paper §3.2): the adaptive prefetcher (Gill &
Bathen's AMP lineage) exists to hide *decompression* latency behind parallel
speculative work — the same mechanism hides *network round-trip* latency
here, because prefetched chunks issue their range-GETs concurrently from the
worker pool while the consumer drains earlier chunks. And the indexed read
path (random access into compressed data, paper §1.3/Fig 9) turns a warm
seek-index into O(range) remote traffic: a read of N decompressed bytes
touches only the compressed spans of the chunks that contain it.

Mechanics:

  * **Block-aligned readahead cache** — preads are rounded out to
    ``block_size`` boundaries and whole blocks are cached (LRU, bounded by
    ``cache_blocks``), so the many small header/footer probes the reader
    issues (gzip header parse, BGZF sniff, footers) ride one round trip.
    Adjacent missing blocks coalesce into a single range request;
    ``readahead_blocks`` extends each fetch run speculatively.
  * **Bounded retry** — 5xx/408/429, timeouts, connection resets, and short
    bodies retry with exponential backoff up to ``max_retries``; exhaustion
    raises ``RemoteIOError``. A ``Retry-After`` header on a throttled
    response (429/503 from an admission-controlled gateway) overrides the
    computed backoff, clamped to ``backoff_max``.
  * **Connection reuse** — one persistent HTTP/1.1 connection per thread
    (the chunk fetcher preads from many worker threads concurrently).
  * **Validators** — ETag/Last-Modified are captured at open and sent back
    via ``If-Range``; any response whose validators (or total size) disagree
    raises ``RemoteFileChangedError`` instead of serving corrupt bytes.
    When the server supplies a validator, mixing bytes from two object
    versions can never happen: a pread either completes against the
    open-time version or raises. Validator-less servers cannot be
    change-detected mid-read (only a size change is caught); for those,
    ``identity()`` returns None so the IndexStore keys indexes by content
    digest rather than trusting the URL.
"""

from __future__ import annotations

import http.client
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import trace as _obs_trace
from .cache import CacheStats, LRUCache
from .errors import RemoteFileChangedError, RemoteIOError
from .filereader import FileReader, check_pread_args

#: Response codes worth retrying: server-side faults and throttling.
TRANSIENT_STATUS = frozenset({408, 429, 500, 502, 503, 504})


def is_remote_url(source) -> bool:
    """True for http(s):// URL strings (the sources this backend serves)."""
    return isinstance(source, str) and source.startswith(("http://", "https://"))


def remote_identity(url: str, **kwargs) -> Optional[str]:
    """Identity string for a remote object (URL + ETag/Last-Modified + size).

    One HEAD round trip, no body bytes — cheap enough for IndexStore key
    derivation on every open. None when the server supplies no validator
    (callers must fall back to a content digest: URL + size alone would
    collide a same-size object replacement with its predecessor).
    """
    kwargs.setdefault("cache_blocks", 1)
    with RemoteFileReader(url, **kwargs) as reader:
        return reader.identity()


@dataclass
class RemoteStats:
    """Network-side counters; block-cache counters live in ``cache_stats``
    (the shared ``CacheStats`` shape the service metrics understand)."""

    requests: int = 0  # HTTP requests issued (incl. the open-time probe)
    retries: int = 0  # re-attempts after a transient failure
    retry_after_waits: int = 0  # retries paced by a server Retry-After header
    bytes_fetched: int = 0  # body bytes received from range responses

    def as_dict(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}


class RemoteFileReader(FileReader):
    """Positioned reads over HTTP(S) via single-range GETs (stdlib only)."""

    def __init__(
        self,
        url: str,
        *,
        block_size: int = 1 << 20,
        cache_blocks: int = 16,
        readahead_blocks: int = 0,
        max_retries: int = 5,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        timeout: float = 30.0,
        headers: Optional[Dict[str, str]] = None,
        sleep: Callable[[float], None] = time.sleep,
        block_cache: Optional[LRUCache] = None,
    ):
        if not is_remote_url(url):
            raise ValueError("not an http(s) URL: %r" % (url,))
        if block_size < 1:
            raise ValueError("block_size must be positive")
        split = urllib.parse.urlsplit(url)
        if not split.netloc:
            raise ValueError("URL has no host: %r" % (url,))
        self._url = url
        self._scheme = split.scheme
        self._netloc = split.netloc
        self._path = split.path or "/"
        if split.query:
            self._path += "?" + split.query
        self._headers = dict(headers or {})
        self._block_size = block_size
        self._cache_blocks = max(1, cache_blocks)
        self._readahead_blocks = max(0, readahead_blocks)
        self._max_retries = max(0, max_retries)
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._timeout = timeout
        self._sleep = sleep

        self._local = threading.local()
        self._conn_lock = threading.Lock()
        self._conns: List[http.client.HTTPConnection] = []
        self._closed = False

        # Block cache: the same thread-safe LRU the chunk fetcher uses
        # (capacity in entries = blocks); hit/miss/eviction accounting comes
        # with it. The in-flight map makes block fetches single-flight:
        # worker threads racing on the same cold block wait for one range
        # GET instead of each issuing their own. An *injected* cache (the
        # service layer passes a pool-backed one) charges these blocks —
        # up to cache_blocks x block_size resident bytes — to the owning
        # tenant's CachePool budget instead of sitting beside it; close()
        # then releases it back to the pool.
        if block_cache is not None:
            self._cache = block_cache
            self._cache_blocks = max(1, getattr(block_cache, "capacity", cache_blocks))
        else:
            self._cache = LRUCache(self._cache_blocks)
        self._inflight: Dict[int, threading.Event] = {}
        self._inflight_lock = threading.Lock()
        self.stats = RemoteStats()
        self._stats_lock = threading.Lock()

        self._etag: Optional[str] = None
        self._last_modified: Optional[str] = None
        try:
            self._size = self._probe()
        except BaseException:
            # A failed construction is never returned, so nothing could
            # ever close() us — release the probe's registered connection
            # here or each caller retry leaks a socket.
            self.close()
            raise

    # -- metadata -----------------------------------------------------------

    @property
    def url(self) -> str:
        return self._url

    @property
    def etag(self) -> Optional[str]:
        return self._etag

    @property
    def last_modified(self) -> Optional[str]:
        return self._last_modified

    def size(self) -> int:
        return self._size

    @property
    def cache_stats(self) -> CacheStats:
        """Block-cache hit/miss/eviction counters."""
        return self._cache.stats

    def identity(self) -> Optional[str]:
        validator = self._etag or self._last_modified
        if validator is None:
            # No validator: (url, size) cannot distinguish a same-size
            # object replacement, and _check_validators would have nothing
            # to catch it with at read time either. Returning None sends
            # file_identity to its head/tail content-digest fallback.
            return None
        return "remote\0%s\0%s\0%d" % (self._url, validator, self._size)

    # -- connection management ---------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (
                http.client.HTTPSConnection
                if self._scheme == "https"
                else http.client.HTTPConnection
            )
            conn = cls(self._netloc, timeout=self._timeout)
            self._local.conn = conn
            with self._conn_lock:
                self._conns.append(conn)
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._conn_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        # A pool-backed injected cache must be *released* (deregistered, its
        # bytes returned to the tenant budget), not just emptied — same
        # duck-typed contract the chunk fetcher uses for its caches.
        release = getattr(self._cache, "release", None)
        if release is not None:
            release()
        else:
            self._cache.clear()

    # -- HTTP plumbing ------------------------------------------------------

    def _do_request(self, method: str, extra_headers: Dict[str, str]):
        """One request/response on this thread's connection.

        Returns (status, message, body). Raises OSError/HTTPException on
        transport faults (the caller's retry loop owns recovery).
        """
        conn = self._connection()
        headers = {**self._headers, **extra_headers}
        # Wire-level trace propagation: when a span is current (this request
        # was issued under tracing), the traceparent header lets the serving
        # gateway stitch its own spans into our trace. One contextvar read
        # per request; absent while tracing is off.
        tp = _obs_trace.current_traceparent()
        if tp is not None:
            headers.setdefault(_obs_trace.TRACEPARENT_HEADER, tp)
        conn.request(method, self._path, headers=headers)
        resp = conn.getresponse()
        # Always drain the response (HEAD drains to b"" — http.client knows
        # the method has no body) or the connection cannot be reused.
        body = resp.read()
        with self._stats_lock:
            self.stats.requests += 1
        if resp.will_close:
            self._drop_connection()
        return resp.status, resp.headers, body

    def _check_validators(self, headers) -> None:
        etag = headers.get("ETag")
        if etag is not None and self._etag is not None:
            if etag != self._etag:
                raise RemoteFileChangedError(
                    "%s: ETag changed from %s to %s" % (self._url, self._etag, etag)
                )
            return
        # ETag unusable on one side or the other (intermediaries strip it,
        # and it can be absent at open yet present later): fall through to
        # Last-Modified so a replaced object is still caught.
        lm = headers.get("Last-Modified")
        if self._last_modified is not None and lm is not None and lm != self._last_modified:
            raise RemoteFileChangedError(
                "%s: Last-Modified changed from %s to %s"
                % (self._url, self._last_modified, lm)
            )

    def _retry_wait(self, attempt: int, retry_after: Optional[float] = None) -> None:
        with self._stats_lock:
            self.stats.retries += 1
            if retry_after is not None:
                self.stats.retry_after_waits += 1
        delay = min(self._backoff_max, self._backoff_base * (2 ** attempt))
        if retry_after is not None:
            # Server-directed pacing (429/503 Retry-After) wins over our own
            # backoff, but stays bounded by backoff_max so a hostile header
            # cannot park the thread.
            delay = min(max(delay, retry_after), self._backoff_max)
        if delay > 0:
            self._sleep(delay)

    def _probe(self) -> int:
        """Open-time HEAD (falling back to a 1-byte range GET): capture size
        and validators against which every later response is checked."""
        last_exc: Optional[BaseException] = None
        retry_after: Optional[float] = None
        for attempt in range(self._max_retries + 1):
            if attempt:
                self._retry_wait(attempt - 1, retry_after)
            retry_after = None
            try:
                status, headers, _ = self._do_request("HEAD", {})
                if status in (405, 501):
                    # No HEAD support: a 1-byte range response carries the
                    # total size in Content-Range and the same validators.
                    status, headers, _ = self._do_request(
                        "GET", {"Range": "bytes=0-0"}
                    )
            except (OSError, http.client.HTTPException) as exc:
                self._drop_connection()
                last_exc = exc
                continue
            if status in TRANSIENT_STATUS:
                retry_after = parse_retry_after(headers.get("Retry-After"))
                last_exc = RemoteIOError("HTTP %d probing %s" % (status, self._url))
                continue
            size: Optional[int] = None
            if status == 200:
                cl = headers.get("Content-Length")
                size = int(cl) if cl is not None else None
            elif status == 206:
                size = _parse_content_range(headers.get("Content-Range"))[1]
            else:
                raise RemoteIOError("HTTP %d probing %s" % (status, self._url))
            if size is None:
                raise RemoteIOError(
                    "%s: server reported no usable size (Content-Length/"
                    "Content-Range missing)" % self._url
                )
            self._etag = headers.get("ETag")
            self._last_modified = headers.get("Last-Modified")
            return size
        raise RemoteIOError(
            "probe of %s failed after %d attempts: %s"
            % (self._url, self._max_retries + 1, last_exc)
        ) from last_exc

    def _fetch_range(self, start: int, end_incl: int) -> bytes:
        """Fetch [start, end_incl] with bounded retry + validator checks."""
        if not _obs_trace.tracing_enabled():
            return self._fetch_range_raw(start, end_incl)
        with _obs_trace.span(
            "remote.range_get",
            {"start": start, "size": end_incl - start + 1, "url": self._url},
        ):
            return self._fetch_range_raw(start, end_incl)

    def _fetch_range_raw(self, start: int, end_incl: int) -> bytes:
        want = end_incl - start + 1
        extra = {"Range": "bytes=%d-%d" % (start, end_incl)}
        if self._etag is not None:
            extra["If-Range"] = self._etag
        last_exc: Optional[BaseException] = None
        retry_after: Optional[float] = None
        for attempt in range(self._max_retries + 1):
            if attempt:
                self._retry_wait(attempt - 1, retry_after)
            retry_after = None
            try:
                status, headers, body = self._do_request("GET", extra)
            except (OSError, http.client.HTTPException) as exc:
                # Timeout, reset, or a short body the transport detected
                # (IncompleteRead): transient — new connection, try again.
                self._drop_connection()
                last_exc = exc
                continue
            if status in TRANSIENT_STATUS:
                retry_after = parse_retry_after(headers.get("Retry-After"))
                last_exc = RemoteIOError(
                    "HTTP %d for bytes=%d-%d of %s" % (status, start, end_incl, self._url)
                )
                continue
            if status == 206:
                self._check_validators(headers)
                cr_start, total = _parse_content_range(headers.get("Content-Range"))
                if total is not None and total != self._size:
                    raise RemoteFileChangedError(
                        "%s: size changed from %d to %d" % (self._url, self._size, total)
                    )
                if cr_start is not None and cr_start != start:
                    # A proxy served a differently-aligned partial object:
                    # body[0] is not our requested start byte, so slicing it
                    # would cache wrong bytes under right keys. Transient —
                    # a retry may reach a conformant origin.
                    last_exc = RemoteIOError(
                        "misaligned Content-Range (starts at %d, wanted %d) from %s"
                        % (cr_start, start, self._url)
                    )
                    continue
                if len(body) < want:
                    # Short body under a healthy status line: transient.
                    last_exc = RemoteIOError(
                        "short range body (%d < %d) from %s" % (len(body), want, self._url)
                    )
                    self._drop_connection()
                    continue
                with self._stats_lock:
                    self.stats.bytes_fetched += want
                return body[:want]
            if status == 200:
                # Server ignored the Range header — either it simply does
                # not do ranges, or our If-Range validator no longer
                # matched. Distinguish via validators/size, then slice.
                self._check_validators(headers)
                if len(body) != self._size:
                    raise RemoteFileChangedError(
                        "%s: full body size %d != open-time size %d"
                        % (self._url, len(body), self._size)
                    )
                with self._stats_lock:
                    self.stats.bytes_fetched += len(body)
                # We paid for the whole object — bank as much of it as the
                # cache holds, forward from the requested run, so sequential
                # reads against a range-less server don't re-download the
                # full body per run.
                bs = self._block_size
                first = start // bs
                for i in range(self._cache_blocks):
                    lo = (first + i) * bs
                    if lo >= len(body):
                        break
                    self._install_block(first + i, body[lo : lo + bs])
                return body[start : end_incl + 1]
            if status == 416:
                raise RemoteFileChangedError(
                    "%s: range bytes=%d-%d no longer satisfiable (object shrank?)"
                    % (self._url, start, end_incl)
                )
            raise RemoteIOError(
                "HTTP %d for bytes=%d-%d of %s" % (status, start, end_incl, self._url)
            )
        raise RemoteIOError(
            "range GET bytes=%d-%d of %s failed after %d attempts: %s"
            % (start, end_incl, self._url, self._max_retries + 1, last_exc)
        ) from last_exc

    # -- block cache + single-flight fetches --------------------------------

    def _install_block(self, b: int, data: bytes) -> None:
        self._cache.insert(b, data)

    def _fetch_run(self, first_block: int, last_block: int) -> bytes:
        """One range request covering a run of blocks."""
        bs = self._block_size
        start = first_block * bs
        end_incl = min(self._size, (last_block + 1) * bs) - 1
        return self._fetch_range(start, end_incl)

    def _claim(self, wanted: List[int]) -> Tuple[List[int], Dict[int, threading.Event]]:
        """Partition blocks into ours-to-fetch vs already-in-flight elsewhere."""
        mine: List[int] = []
        theirs: Dict[int, threading.Event] = {}
        with self._inflight_lock:
            for b in wanted:
                ev = self._inflight.get(b)
                if ev is None:
                    self._inflight[b] = threading.Event()
                    mine.append(b)
                else:
                    theirs[b] = ev
        return mine, theirs

    def _release(self, claimed: List[int]) -> None:
        with self._inflight_lock:
            for b in claimed:
                ev = self._inflight.pop(b, None)
                if ev is not None:
                    ev.set()

    def _fetch_missing(self, missing: List[int], last: int, blocks: Dict[int, bytes]) -> None:
        """Fill ``blocks`` for every index in ``missing`` (all <= ``last``).

        Single-flight: blocks another thread is already fetching are waited
        on, not re-downloaded — at parallelization N the chunk prefetcher's
        workers race on overlapping margins, and without deduplication cold
        reads fetch ~2x the archive over the wire.
        """
        bs = self._block_size
        wanted = set(missing)
        mine, theirs = self._claim(missing)
        try:
            runs: List[List[int]] = []
            for b in mine:
                if runs and b == runs[-1][1] + 1:
                    runs[-1][1] = b
                else:
                    runs.append([b, b])
            if runs and self._readahead_blocks and runs[-1][1] == last:
                # Speculatively extend the final fetch past the request: the
                # next sequential pread then lands in cache (latency hiding
                # one level below the chunk prefetcher). Extension blocks
                # must be free (uncached, unclaimed) to stay single-flight.
                max_block = (self._size - 1) // bs
                b = last + 1
                while b <= max_block and b - last <= self._readahead_blocks and b not in self._cache:
                    claimed, _ = self._claim([b])
                    if not claimed:
                        break
                    mine.extend(claimed)
                    runs[-1][1] = b
                    b += 1
            for lo, hi in runs:
                data = self._fetch_run(lo, hi)
                # Serve from the fetched buffer directly — a run longer
                # than the LRU capacity must not depend on its own blocks
                # surviving insertion; the cache is opportunistic readahead.
                for b in range(lo, hi + 1):
                    piece = data[(b - lo) * bs : (b - lo + 1) * bs]
                    self._install_block(b, piece)
                    if b in wanted:
                        blocks[b] = piece
        finally:
            self._release(mine)  # on failure too: waiters fall back below
        for b, ev in theirs.items():
            ev.wait()
            blocks[b] = self._get_or_fetch_single(b)

    def _get_or_fetch_single(self, b: int) -> bytes:
        """Cache lookup with single-flight refetch for a woken waiter whose
        block is gone (the other fetch failed, or a fetch run longer than
        the LRU evicted it before we woke). Claimed like any other fetch so
        multiple stranded waiters still share one range GET."""
        while True:
            # peek: pread's initial get() already recorded this logical
            # access as a miss (we did wait on the network); a stats-counted
            # hit here would double-book it, and the block is MRU already.
            val = self._cache.peek(b)
            if val is not None:
                return val
            mine, theirs = self._claim([b])
            if mine:
                try:
                    val = self._fetch_run(b, b)
                    self._install_block(b, val)
                    return val
                finally:
                    self._release(mine)
            theirs[b].wait()  # someone else claimed meanwhile: wait, recheck

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        if self._closed:
            raise ValueError("pread on closed RemoteFileReader")
        if offset >= self._size or size == 0:
            return b""
        size = min(size, self._size - offset)
        bs = self._block_size
        first = offset // bs
        last = (offset + size - 1) // bs

        blocks: Dict[int, bytes] = {}
        missing: List[int] = []
        for b in range(first, last + 1):
            data = self._cache.get(b)  # records one hit or miss per block
            if data is not None:
                blocks[b] = data
            else:
                missing.append(b)
        if missing:
            self._fetch_missing(missing, last, blocks)

        # Trim only the edge blocks, then one join — chunk-sized preads are
        # the decompression hot path, so avoid whole-result re-copies.
        head_skip = offset - first * bs
        if first == last:
            return blocks[first][head_skip : head_skip + size]
        parts = [blocks[b] for b in range(first, last + 1)]
        parts[0] = parts[0][head_skip:]
        tail_keep = offset + size - last * bs
        if tail_keep < len(parts[-1]):
            parts[-1] = parts[-1][:tail_keep]
        return b"".join(parts)


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Seconds out of a Retry-After header (delta-seconds form only).

    The HTTP-date form is legal but never emitted by our gateway and rarely
    by object stores; it parses to None and the caller falls back to its own
    backoff. Negative/garbage values also parse to None.
    """
    if not value:
        return None
    try:
        seconds = float(value.strip())
    except ValueError:
        return None
    return seconds if seconds >= 0 else None


def _parse_content_range(value: Optional[str]) -> Tuple[Optional[int], Optional[int]]:
    """(start, total) out of 'bytes a-b/N'; None fields when absent/'*'."""
    if not value or "/" not in value:
        return None, None
    spec, total_s = value.rsplit("/", 1)
    total: Optional[int] = None
    total_s = total_s.strip()
    if total_s != "*":
        try:
            total = int(total_s)
        except ValueError:
            total = None
    start: Optional[int] = None
    spec = spec.strip()
    if spec.startswith("bytes") and "-" in spec:
        try:
            start = int(spec[len("bytes"):].strip().split("-", 1)[0])
        except ValueError:
            start = None
    return start, total
