"""GatewayClient — the FileReader contract spoken over the gateway wire.

Management verbs (open/stat/close/metrics) are thin one-shot JSON calls;
the data path *is* `core.remote.RemoteFileReader` pointed at the handle's
``/bytes`` endpoint. That is deliberate, not lazy: the bytes endpoint
speaks exactly the single-range dialect the remote backend already
implements (206/416, ``Content-Range``, ``ETag`` + ``If-Range``, bounded
retry with backoff on 429/5xx), so the gateway inherits a battle-tested
client and — the chaining dividend — anything that can read a remote
object can read a gateway: ``ArchiveServer.open(gw.bytes_url(h))`` makes a
second-tier archive service front a first-tier gateway with zero new code.

What the wrapper adds on top of the inner remote reader:

  * ``open`` semantics: constructing with ``source=`` POSTs the archive
    open and owns the handle (``close()`` DELETEs it); constructing with
    ``handle=`` attaches to an existing handle and leaves its lifetime to
    the owner.
  * ``stream()``: the chunked full-body read (one ``GET`` without
    ``Range``), yielded incrementally — the acceptance path for "bytes
    identical over a chunked stream", and the easiest way to *abandon* a
    stream mid-flight (closing the generator drops the connection, which
    is precisely the cancellation signal the gateway tests exercise).
    ``stream(offset=n)`` resumes mid-body via ``Range: bytes=n-`` with
    ETag continuity checking — fleet failover's exact-resume primitive.
  * an admission-aware retry budget: management-verb 429s are retried,
    paced by the server's ``Retry-After``, within ``retry_budget`` seconds
    of total wait instead of failing immediately.
  * ``revalidate(etag)``: conditional GET (``If-None-Match`` + 1-byte
    Range) — object-version equality for the price of headers.
  * bearer-token auth on every request (``token=``).

`GatewayClient` is a `FileReader`: ``pread``/``size``/``identity``/``view``
satisfy the same contract suite as the bytes/mmap/python/remote backends
(tests/test_filereader_contract.py) — over a live socket.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.parse
from typing import Any, Dict, Iterator, Optional

from ...core.errors import RemoteFileChangedError, RemoteIOError
from ...core.filereader import FileReader, check_pread_args
from ...core.remote import RemoteFileReader, parse_retry_after
from ...obs import trace as _obs_trace


class GatewayError(RemoteIOError):
    """A gateway management verb failed (non-2xx status)."""

    def __init__(self, status: int, message: str, retry_after: Optional[float] = None):
        super().__init__("HTTP %d: %s" % (status, message))
        self.status = status
        #: Parsed ``Retry-After`` seconds on a 429/503, else None.
        self.retry_after = retry_after


class GatewayClient(FileReader):
    """Positioned reads of an archive's *decompressed* bytes via a gateway.

    ``GatewayClient(url, source="/data/x.gz")`` opens (and owns) a handle;
    ``GatewayClient(url, handle="f3")`` attaches to one opened elsewhere.
    Extra keyword arguments tune the inner `RemoteFileReader` (block_size,
    cache_blocks, retry/backoff, timeout).
    """

    def __init__(
        self,
        base_url: str,
        source: Optional[str] = None,
        *,
        handle: Optional[str] = None,
        token: Optional[str] = None,
        tenant: Optional[str] = None,
        timeout: float = 30.0,
        retry_budget: float = 8.0,
        **remote_options: Any,
    ):
        if (source is None) == (handle is None):
            raise ValueError("pass exactly one of source= or handle=")
        if retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        split = urllib.parse.urlsplit(base_url)
        if split.scheme not in ("http", "https") or not split.netloc:
            raise ValueError("not a gateway base URL: %r" % (base_url,))
        self._base = base_url.rstrip("/")
        self._scheme = split.scheme
        self._netloc = split.netloc
        self._timeout = timeout
        self._retry_budget = retry_budget
        #: Management-verb 429s absorbed by the retry budget (telemetry).
        self.retries_429 = 0
        self._headers: Dict[str, str] = {}
        if token is not None:
            self._headers["Authorization"] = "Bearer %s" % token
        self._closed = False
        self._remote: Optional[RemoteFileReader] = None

        if source is not None:
            spec: Dict[str, Any] = {"source": source}
            if tenant is not None:
                spec["tenant"] = tenant
            status, payload = self._request("POST", "/v1/archives", spec)
            handle = payload["handle"]
            self.tenant = payload.get("tenant")
            self._owns_handle = True
        else:
            self.tenant = tenant
            self._owns_handle = False
        self.handle = handle
        self._bytes_path = "/v1/archives/%s/bytes" % handle
        try:
            # The inner reader's open-time HEAD captures decompressed size +
            # ETag; on a cold archive that HEAD drives the speculative first
            # pass server-side (the price of knowing Content-Length).
            self._remote = RemoteFileReader(
                self._base + self._bytes_path,
                headers=dict(self._headers),
                timeout=timeout,
                **remote_options,
            )
        except BaseException:
            self.close()
            raise

    # -- FileReader contract -------------------------------------------------

    def size(self) -> int:
        return self._remote.size()

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        if self._closed:
            raise ValueError("pread on closed GatewayClient")
        return self._remote.pread(offset, size)

    def identity(self) -> Optional[str]:
        return self._remote.identity()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._remote is not None:
                self._remote.close()
        finally:
            if self._owns_handle:
                # A 429 here means our tenant is momentarily at its
                # admission limit — _request's retry budget absorbs it
                # rather than silently leaking the server-side handle
                # (reader + pool-charged cache bytes stay alive until
                # gateway shutdown otherwise).
                try:
                    self._request("DELETE", "/v1/archives/%s" % self.handle)
                except GatewayError:
                    pass  # already closed / gone / budget spent
                except (OSError, http.client.HTTPException):
                    pass  # gateway already gone

    # -- gateway extras ------------------------------------------------------

    @property
    def etag(self) -> Optional[str]:
        return self._remote.etag

    @property
    def remote_stats(self):
        """Inner RemoteFileReader network counters (requests/retries/bytes)."""
        return self._remote.stats

    def revalidate(self, etag: str) -> bool:
        """True iff the gateway's current entity for this handle matches
        ``etag``.

        Conditional GET (``If-None-Match`` + a 1-byte ``Range``): a match
        answers 304 with no body, a mismatch at most one body byte — never
        a full-body refetch. Fleet failover uses this to confirm a new peer
        serves the same object version before resuming mid-stream.
        """
        headers = dict(self._headers)
        headers["If-None-Match"] = etag
        headers["Range"] = "bytes=0-0"
        conn = self._connect()
        try:
            conn.request("GET", self._bytes_path, headers=headers)
            resp = conn.getresponse()
            resp.read()
            if resp.status == 304:
                return True
            if resp.status in (200, 206):
                current = resp.getheader("ETag")
                return current is not None and current == etag
            raise GatewayError(
                resp.status, "revalidation failed",
                parse_retry_after(resp.getheader("Retry-After")),
            )
        finally:
            conn.close()

    def fetch_index(self) -> Optional[bytes]:
        """The handle's finalized seek-index blob, or None (404: not yet
        finalized). The exchange counterpart to ``GET .../index``."""
        conn = self._connect()
        try:
            conn.request(
                "GET", "/v1/archives/%s/index" % self.handle,
                headers=dict(self._headers),
            )
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status == 200:
                return raw
            if resp.status == 404:
                return None
            raise GatewayError(
                resp.status, raw.decode(errors="replace"),
                parse_retry_after(resp.getheader("Retry-After")),
            )
        finally:
            conn.close()

    def stream(self, *, read_size: int = 64 << 10, offset: int = 0) -> Iterator[bytes]:
        """Yield the decompressed body incrementally from ``offset`` on.

        ``offset=0`` is the chunked full-body 200; ``offset>0`` resumes via
        ``Range: bytes=offset-`` (206) — the exact-resume primitive fleet
        failover relies on. A resumed response whose ETag no longer matches
        the open-time one raises `RemoteFileChangedError` instead of
        splicing bytes of two object versions into one stream.

        Uses a dedicated connection so an abandoned generator (``close()``
        or ``break``) drops the socket — which the gateway observes as a
        mid-stream disconnect and turns into end-to-end cancellation.
        """
        if self._closed:
            raise ValueError("stream on closed GatewayClient")
        if offset < 0:
            raise ValueError("offset must be >= 0")
        headers = dict(self._headers)
        expect = 200
        if offset:
            headers["Range"] = "bytes=%d-" % offset
            expect = 206
        conn = self._connect()
        try:
            conn.request("GET", self._bytes_path, headers=headers)
            resp = conn.getresponse()
            if offset and resp.status == 416:
                resp.read()
                return  # resuming exactly at EOF: nothing left to yield
            if resp.status != expect:
                raise GatewayError(
                    resp.status, resp.read().decode(errors="replace"),
                    parse_retry_after(resp.getheader("Retry-After")),
                )
            if offset:
                ours = self._remote.etag if self._remote is not None else None
                theirs = resp.getheader("ETag")
                if ours is not None and theirs is not None and ours != theirs:
                    raise RemoteFileChangedError(
                        "%s: ETag changed from %s to %s while resuming at %d"
                        % (self._bytes_path, ours, theirs, offset)
                    )
            while True:
                data = resp.read(read_size)
                if not data:
                    return
                yield data
        finally:
            conn.close()

    def stat(self) -> Dict[str, Any]:
        status, payload = self._request(
            "GET", "/v1/archives/%s/stat" % self.handle
        )
        return payload

    def metrics(self) -> Dict[str, Any]:
        status, payload = self._request("GET", "/v1/metrics")
        return payload

    # -- plumbing ------------------------------------------------------------

    def _connect(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self._scheme == "https"
            else http.client.HTTPConnection
        )
        return cls(self._netloc, timeout=self._timeout)

    def _request(self, method: str, path: str, payload: Optional[Dict] = None):
        """Management call; returns (status, decoded JSON body).

        Admission-aware: a 429 is retried within ``retry_budget`` seconds of
        total wait, paced by the server's ``Retry-After`` when present (the
        admission controller knows its own queue better than our backoff
        guess). The budget bounds *wall-clock spent waiting*, not attempt
        count — under fleet failover every surviving peer absorbs the dead
        peer's clients at once, so immediate-fail on the resulting 429 burst
        would turn one node loss into a client-visible error storm.
        """
        budget = self._retry_budget
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, payload)
            except GatewayError as exc:
                if exc.status != 429:
                    raise
                delay = exc.retry_after
                if delay is None or delay <= 0:
                    delay = min(1.0, 0.1 * (2 ** attempt))
                if delay > budget:
                    raise  # budget exhausted: surface the 429 to the caller
                budget -= delay
                attempt += 1
                self.retries_429 += 1
                time.sleep(delay)

    def _request_once(self, method: str, path: str, payload: Optional[Dict] = None):
        body = json.dumps(payload).encode() if payload is not None else None
        headers = dict(self._headers)
        if body is not None:
            headers["Content-Type"] = "application/json"
        # Management verbs join the caller's trace the same way the data path
        # does (RemoteFileReader injects this inside core.remote).
        tp = _obs_trace.current_traceparent()
        if tp is not None:
            headers.setdefault(_obs_trace.TRACEPARENT_HEADER, tp)
        conn = self._connect()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 400:
                try:
                    message = json.loads(raw.decode() or "{}").get("error", "")
                except (ValueError, UnicodeDecodeError):
                    message = raw.decode(errors="replace")
                raise GatewayError(
                    resp.status, message,
                    parse_retry_after(resp.getheader("Retry-After")),
                )
            decoded = json.loads(raw.decode()) if raw else None
            return resp.status, decoded
        finally:
            conn.close()
