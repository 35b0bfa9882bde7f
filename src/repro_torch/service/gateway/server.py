"""GatewayServer — stdlib asyncio HTTP/1.1 front-end over AsyncArchiveServer.

One event loop (in a dedicated thread, so the server embeds in synchronous
programs and tests), one coroutine per connection, zero dependencies. Every
request rides `AsyncArchiveServer`'s bridge: the loop never blocks on
decompression, however cold the archive.

Concurrency/cancellation contract per connection:

  * each parsed request is handled as its own task while a **disconnect
    watcher** (a 1-byte read on the connection) runs alongside it. EOF from
    the watcher means the client is gone: the handler task is cancelled,
    which (a) cancels the in-flight bridged await — a queued bridge call
    never starts (`AsyncArchiveServer` books it under
    ``bridge_stats()['cancelled']``) — and (b) sweeps the handle's queued
    FairExecutor prefetch backlog via `ArchiveServer.cancel_queued`, where
    the executor books them under ``cancelled``. At quiescence the books
    always balance: ``submitted == done + cancelled + queued``.
  * large spans stream chunked, one ``stream_span`` read per await; a write
    failure mid-stream (reset) triggers the same cleanup path.

Admission (`TenantAdmission`) gates every ``/v1/archives`` request before
it can touch a bridge thread; over-budget tenants receive 429 +
``Retry-After``. ``/v1/metrics`` is exempt (operators must be able to look
at an overloaded gateway).

Source opening policy: ``open_roots`` (when given) jails ``POST
/v1/archives`` paths to those directory trees, and
``allow_remote_sources`` gates http(s) URLs — a gateway that fronts other
gateways (chaining) keeps it True.

Adapted from the JAX package's ``service/gateway/server.py`` in how it
closes. ``close()`` must return while a client still holds a keep-alive
connection: the fleet kills a peer with exactly that call. On Python 3.12
``asyncio.Server.wait_closed()`` waits for every open connection, so the
teardown closes the listener, cancels the connection tasks, aborts their
transports and gathers them, and only then awaits ``wait_closed()`` (the
reference awaits it first and times out after 15 s). An owned
`ArchiveServer`, and with it its stage-2 engine, is shut down even when the
teardown fails.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple
from urllib.parse import parse_qs

from ...core.remote import is_remote_url
from ...obs import hist as _obs_hist
from ...obs import trace as _obs_trace
from ...obs.prom import render_prometheus
from ...obs.sanitize import sanitize_snapshot
from ..async_server import AsyncArchiveServer
from ..index_store import _is_key
from ..server import ArchiveServer
from .admission import AdmissionDenied, TenantAdmission, Unauthorized

_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 206: "Partial Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 416: "Range Not Satisfiable",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}

MAX_HEADER_BYTES = 32 << 10
MAX_BODY_BYTES = 1 << 20


@dataclass
class _Request:
    method: str
    path: str
    headers: Dict[str, str]  # keys lower-cased
    body: bytes
    query: str = ""  # raw query string, no leading '?'


class _BadRequest(Exception):
    """Malformed wire input; answered with ``status`` then the connection
    closes (the stream position is no longer trustworthy)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _GatewayStats:
    """Front-door counters (read from any thread, bumped on the loop)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._tenant_bytes: Dict[str, int] = {}
        self._streams: Dict[int, Dict[str, Any]] = {}
        self._stream_seq = 0

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def served(self, tenant: str, n: int) -> None:
        with self._lock:
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + n

    # Per-stream progress: a fleet health probe polling /v1/metrics can tell
    # a stuck peer (sent frozen across probes while a stream is registered)
    # from a merely slow one (sent advancing) — liveness data that a single
    # cumulative byte counter cannot provide once several streams multiplex.

    def stream_begin(self, handle: str, tenant: str, total: int) -> int:
        with self._lock:
            self._stream_seq += 1
            sid = self._stream_seq
            self._streams[sid] = {
                "handle": handle, "tenant": tenant, "sent": 0, "total": total
            }
            return sid

    def stream_progress(self, sid: int, n: int) -> None:
        with self._lock:
            st = self._streams.get(sid)
            if st is not None:
                st["sent"] += n

    def stream_end(self, sid: int) -> None:
        with self._lock:
            self._streams.pop(sid, None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
            out["bytes_served_per_tenant"] = dict(self._tenant_bytes)
            out["streams_in_progress"] = {
                str(sid): dict(st) for sid, st in self._streams.items()
            }
            return out


def _etag_matches(header_value: str, etag: str) -> bool:
    """``If-None-Match`` comparison: ``*``, or any listed entity-tag equal to
    ours. Weak-comparison (RFC 9110 §8.8.3.2): a ``W/`` prefix on either side
    is ignored — correct for 304 revalidation, which this header serves."""
    header_value = header_value.strip()
    if header_value == "*":
        return True
    ours = etag[2:] if etag.startswith("W/") else etag
    for candidate in header_value.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == ours:
            return True
    return False


def _parse_range(value: Optional[str], size: int):
    """``Range`` header -> (start, stop_exclusive) | None | "invalid" | "unsat".

    Handles the three RFC 9110 single-range shapes: ``bytes=a-b``,
    open-ended ``bytes=a-``, and suffix ``bytes=-n``. Multi-range requests
    are answered as invalid (full 200 body) — one span per request is the
    dialect `RemoteFileReader` speaks.
    """
    if not value:
        return None
    if size <= 0:
        # No byte of a zero-length body is addressable; RFC 9110 says 416
        # (a 206 here would emit the malformed 'bytes 0--1/0').
        return "unsat"
    value = value.strip()
    if not value.startswith("bytes="):
        return "invalid"
    spec = value[len("bytes="):].strip()
    if "," in spec or "-" not in spec:
        return "invalid"
    a_s, _, b_s = spec.partition("-")
    a_s, b_s = a_s.strip(), b_s.strip()
    try:
        if not a_s:  # suffix: last n bytes
            n = int(b_s)
            if n <= 0:
                return "unsat"
            return max(0, size - n), size
        start = int(a_s)
        if start >= size:
            return "unsat"
        if not b_s:
            return start, size
        end_incl = int(b_s)
        if end_incl < start:
            return "invalid"
        return start, min(end_incl + 1, size)
    except ValueError:
        return "invalid"


class GatewayServer:
    """HTTP wire front-end over an `ArchiveServer` (owned or wrapped).

    ``GatewayServer(cache_budget_bytes=...)`` builds and owns its backing
    server; ``GatewayServer(existing_server)`` fronts one the caller keeps
    responsibility for. ``start()`` (or ``with``) binds the socket; ``url``
    is then routable.
    """

    def __init__(
        self,
        server: Optional[ArchiveServer] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        admission: Optional[TenantAdmission] = None,
        stream_span: int = 1 << 20,
        front_end_threads: int = 8,
        open_roots: Optional[Sequence[str]] = None,
        allow_remote_sources: bool = True,
        idle_timeout: float = 60.0,
        **server_kwargs: Any,
    ):
        if server is not None and server_kwargs:
            raise ValueError("pass either a server or ArchiveServer kwargs, not both")
        self._sync = server if server is not None else ArchiveServer(**server_kwargs)
        self._owns_sync = server is None
        self.admission = admission if admission is not None else TenantAdmission()
        self.stream_span = max(1, stream_span)
        self.front_end_threads = front_end_threads
        self.open_roots = (
            [os.path.realpath(os.fspath(r)) for r in open_roots]
            if open_roots is not None else None
        )
        self.allow_remote_sources = allow_remote_sources
        self.idle_timeout = idle_timeout
        auth_required = bool(self.admission.tokens) and self.admission.default_tenant is None
        if (
            host not in ("127.0.0.1", "localhost", "::1")
            and not auth_required
            and self.open_roots is None
        ):
            # Binding a routable interface with an unjailed, anonymous-
            # reachable POST /v1/archives would serve any readable file on
            # the machine to any network peer. Require an explicit opt-in:
            # an open_roots jail, or bearer tokens with default_tenant=None
            # (tokens alone don't help while a default tenant still admits
            # requests with no Authorization header at all).
            raise ValueError(
                "refusing to bind %r without an open_roots jail or required "
                "bearer auth (TenantAdmission(tokens=..., "
                "default_tenant=None)); anonymous clients could open any "
                "local path" % (host,)
            )
        self._host = host
        self._port = port
        self.stats = _GatewayStats()

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._asrv: Optional[AsyncArchiveServer] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self._conn_writers: set = set()
        self._tenant_of: Dict[str, str] = {}  # handle -> opener's tenant
        self._started = False
        self._closed = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "GatewayServer":
        if self._started:
            return self
        if self._closed:
            raise RuntimeError("gateway is closed")
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="gateway-loop", daemon=True
        )
        self._thread.start()
        try:
            fut = asyncio.run_coroutine_threadsafe(self._startup(), self._loop)
            self._port = fut.result(timeout=15)
        except BaseException:
            self._stop_loop()
            raise
        self._started = True
        return self

    async def _startup(self) -> int:
        self._asrv = AsyncArchiveServer(
            self._sync, front_end_threads=self.front_end_threads
        )
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port
        )
        return self._server.sockets[0].getsockname()[1]

    @property
    def url(self) -> str:
        """Base URL (no trailing slash), e.g. ``http://127.0.0.1:40213``."""
        if not self._started:
            raise RuntimeError("gateway not started")
        return "http://%s:%d" % (self._host, self._port)

    @property
    def server(self) -> ArchiveServer:
        """The backing synchronous server (telemetry, in-process co-access)."""
        return self._sync

    def bytes_url(self, handle: str) -> str:
        return "%s/v1/archives/%s/bytes" % (self.url, handle)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._started:
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._teardown(), self._loop
                    ).result(timeout=15)
                finally:
                    self._stop_loop()
        finally:
            if self._owns_sync:
                self._sync.shutdown()

    async def _teardown(self) -> None:
        # Stop accepting first; wait_closed() comes last, once every
        # connection is gone (on 3.12 it waits for open connections, and a
        # keep-alive client would hold it until the timeout).
        if self._server is not None:
            self._server.close()
        for task in list(self._conn_tasks):
            task.cancel()
        # Abort every remaining transport, for two reasons. (1) A cancelled
        # handler still closes its writer gracefully, and that close flushes
        # buffered response bytes — unbounded when the client stopped
        # reading (paused stream, full socket buffers). (2) On Python <3.12
        # wait_for() can swallow a cancellation that races the inner future
        # completing (bpo-42130) — a handler parked in _drain can survive
        # its cancel and keep streaming. Either way the response was already
        # cut mid-body, so buffered bytes carry no value; a dead transport
        # makes the survivor's next drain raise ConnectionResetError and the
        # gather below terminate.
        for w in list(self._conn_writers):
            transport = w.transport
            if transport is not None:
                transport.abort()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        if self._asrv is not None:
            await self._asrv.shutdown()  # bridge only: we own the sync server

    def _stop_loop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._loop is not None and not self._thread.is_alive():
            # Release the loop's selector + self-pipe fds now, not at GC.
            self._loop.close()

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Backing-server fleet metrics + gateway/bridge/admission sections."""
        snap = self._sync.metrics()
        snap["gateway"] = self.stats.snapshot()
        if self._asrv is not None:
            snap["bridge"] = self._asrv.bridge_stats()
        snap["admission"] = self.admission.snapshot()
        return snap

    async def _serve_metrics(self, req: _Request, writer) -> None:
        """``GET /v1/metrics`` (JSON by default) / ``GET /metrics``
        (Prometheus text by default — scrapers hitting the conventional
        path never send a query string). Both honor an explicit
        ``?format=json|prometheus``.

        The snapshot crosses the wire boundary through `sanitize_snapshot`
        so whatever instrumented layers stuffed into their stats dicts
        (tuple keys, sets, NaNs, numpy scalars) serializes deterministically.
        """
        snap = sanitize_snapshot(self.metrics())
        default = "prometheus" if req.path.rstrip("/") == "/metrics" else "json"
        fmt = parse_qs(req.query).get("format", [default])[-1].lower()
        if fmt == "prometheus":
            body = render_prometheus(snap).encode()
            await self._send(
                writer, 200,
                {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
                body,
            )
            return
        if fmt != "json":
            await self._send_error(
                writer, 400, "unknown metrics format %r (json|prometheus)" % fmt
            )
            return
        await self._send_json(writer, 200, snap)

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._conn_writers.add(writer)
        pushback = b""
        try:
            while True:
                req = await self._read_request(reader, pushback)
                if req is None:
                    break
                pushback = b""
                self.stats.bump("requests")
                handler = asyncio.ensure_future(self._dispatch(req, writer))
                # Disconnect watcher: clients do not pipeline (one request,
                # then they read the full response), so bytes arriving while
                # we serve are either EOF (client gone — cancel everything
                # end to end) or an eager next request (push the byte back).
                watcher = asyncio.ensure_future(reader.read(1))
                try:
                    await asyncio.wait(
                        {handler, watcher}, return_when=asyncio.FIRST_COMPLETED
                    )
                except asyncio.CancelledError:
                    # Gateway teardown cancelled this connection task:
                    # asyncio.wait does NOT cancel its children — reap them
                    # here or the handler outlives the loop (admission slot
                    # leaked, 'Task was destroyed but it is pending!').
                    handler.cancel()
                    watcher.cancel()
                    await asyncio.gather(handler, watcher, return_exceptions=True)
                    raise
                if not handler.done():
                    disconnected = True
                    try:
                        disconnected = watcher.result() == b""
                    except (ConnectionError, OSError):
                        pass
                    if disconnected:
                        self.stats.bump("disconnects_mid_request")
                        handler.cancel()
                        await asyncio.gather(handler, return_exceptions=True)
                        break
                    pushback = watcher.result()
                # Reap the watcher *before* awaiting the handler: a handler
                # raising a socket error must not leave an unretrieved task.
                if not watcher.done():
                    watcher.cancel()
                extra = (await asyncio.gather(watcher, return_exceptions=True))[0]
                keep = await handler
                if isinstance(extra, bytes):
                    if extra == b"":
                        keep = False  # client already sent FIN
                    else:
                        pushback = extra
                if not keep:
                    break
        except _BadRequest as exc:
            self.stats.bump("bad_requests")
            try:
                await self._send_error(writer, exc.status, str(exc))
            except (ConnectionError, OSError):
                pass
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError, OSError):
            pass
        finally:
            self._conn_tasks.discard(task)
            self._conn_writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _readline(self, reader: asyncio.StreamReader) -> bytes:
        """readline under the idle timeout, with StreamReader's 64 KiB line
        limit surfaced as a 431 instead of an unhandled ValueError."""
        try:
            return await asyncio.wait_for(reader.readline(), self.idle_timeout)
        except ValueError:
            # LimitOverrunError (a ValueError): line exceeds the stream limit.
            raise _BadRequest(431, "request line too long")

    async def _read_request(
        self, reader: asyncio.StreamReader, pushback: bytes
    ) -> Optional[_Request]:
        try:
            line = pushback + await self._readline(reader)
        except asyncio.TimeoutError:
            return None
        if not line.strip():
            if not line:
                return None  # clean EOF between requests
            try:
                # Tolerate a stray CRLF — but under the same idle timeout as
                # every other read, or a silent client pins this task forever.
                line = await self._readline(reader)
            except asyncio.TimeoutError:
                return None
            if not line.strip():
                return None
        try:
            method, path, _version = line.decode("latin-1").split(None, 2)
        except ValueError:
            raise _BadRequest(400, "malformed request line")
        headers: Dict[str, str] = {}
        total = len(line)
        while True:
            hline = await self._readline(reader)
            total += len(hline)
            if total > MAX_HEADER_BYTES:
                raise _BadRequest(431, "request headers too large")
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length")
        if length < 0:
            raise _BadRequest(400, "malformed Content-Length")
        if length:
            if length > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            body = await asyncio.wait_for(reader.readexactly(length), self.idle_timeout)
        path, _, query = path.partition("?")
        return _Request(method.upper(), path, headers, body, query)

    # ------------------------------------------------------------------
    # response plumbing
    # ------------------------------------------------------------------

    async def _drain(self, writer) -> None:
        """drain() under the idle timeout: a connected client that stopped
        *reading* (full TCP send buffer, slow-loris style) must count as
        gone — otherwise it pins its handler task and admission slot
        forever, since the EOF watcher never fires for a merely-stalled
        socket."""
        try:
            await asyncio.wait_for(writer.drain(), self.idle_timeout)
        except asyncio.TimeoutError:
            raise ConnectionResetError("client stopped reading the response")

    async def _send(
        self,
        writer,
        status: int,
        headers: Optional[Dict[str, str]] = None,
        body: bytes = b"",
        *,
        head_only: bool = False,
        content_length: Optional[int] = None,
    ) -> None:
        hdrs = {"Server": "rapidgzip-gateway"}
        hdrs.update(headers or {})
        if "Transfer-Encoding" not in hdrs:
            hdrs.setdefault(
                "Content-Length",
                str(len(body) if content_length is None else content_length),
            )
        out = ["HTTP/1.1 %d %s" % (status, _REASONS.get(status, "Unknown"))]
        out.extend("%s: %s" % kv for kv in hdrs.items())
        writer.write(("\r\n".join(out) + "\r\n\r\n").encode("latin-1"))
        if body and not head_only:
            writer.write(body)
        await self._drain(writer)

    async def _send_json(
        self, writer, status: int, payload: Any, headers: Optional[Dict[str, str]] = None
    ) -> None:
        body = json.dumps(payload, default=str).encode()
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        await self._send(writer, status, hdrs, body)

    async def _send_error(
        self, writer, status: int, message: str, headers: Optional[Dict[str, str]] = None
    ) -> None:
        await self._send_json(writer, status, {"error": message}, headers)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    async def _dispatch(self, req: _Request, writer) -> bool:
        """Route one request; returns False when the connection must close.

        An incoming ``traceparent`` header adopts the caller's trace: the
        per-request span (and everything it fans out to — admission wait,
        bridge hop, executor run, remote range-GETs) parents under the
        remote caller's span, so a FleetClient read that fails over across
        two gateways stitches into one trace. The contextvar set here is
        task-local (one asyncio task per request), so concurrent requests
        never cross-contaminate.
        """
        parent = _obs_trace.parse_traceparent(
            req.headers.get(_obs_trace.TRACEPARENT_HEADER)
        )
        with _obs_trace.attach(parent), _obs_trace.timed(
            "gateway.request", {"method": req.method, "path": req.path}, parent=parent
        ):
            return await self._dispatch_routed(req, writer)

    async def _dispatch_routed(self, req: _Request, writer) -> bool:
        keep = req.headers.get("connection", "").lower() != "close"
        parts = [p for p in req.path.split("/") if p]
        try:
            # /metrics is the conventional Prometheus scrape path; /v1/metrics
            # the API-shaped one. Both are admission-exempt (operators must be
            # able to look at an overloaded gateway).
            if req.method == "GET" and parts in (["v1", "metrics"], ["metrics"]):
                await self._serve_metrics(req, writer)
                return keep
            if parts[:2] != ["v1", "archives"]:
                await self._send_error(writer, 404, "no such route: %s" % req.path)
                return keep
            tenant = self.admission.resolve(req.headers.get("authorization"))
            # Post-hoc span (not a live one): the admission wait is over by
            # the time anything could parent under it, and on the warm path
            # a completed-span record is about half the price of a Span.
            # `record_span` observes the histogram itself, so the disabled
            # branch keeps the always-on boundary timer without double
            # counting.
            t0_adm = time.perf_counter()
            await self.admission.acquire(tenant)
            wait_adm = time.perf_counter() - t0_adm
            if _obs_trace.tracing_enabled():
                _obs_trace.record_span(
                    "gateway.admission_wait", t0_adm, wait_adm, {"tenant": tenant}
                )
            else:
                _obs_hist.observe("gateway.admission_wait", wait_adm)
            try:
                return await self._dispatch_archives(req, writer, parts, tenant, keep)
            finally:
                self.admission.release(tenant)
        except Unauthorized as exc:
            self.stats.bump("unauthorized")
            await self._send_error(
                writer, 401, str(exc), {"WWW-Authenticate": "Bearer"}
            )
            return keep
        except AdmissionDenied as exc:
            self.stats.bump("rejected_429")
            # RFC 9110 delta-seconds is a non-negative *integer* — round the
            # configured delay up so strict clients honor it.
            await self._send_error(
                writer, 429, str(exc),
                {"Retry-After": "%d" % max(1, -(-exc.retry_after // 1))},
            )
            return keep
        except KeyError as exc:
            await self._send_error(writer, 404, str(exc))
            return keep
        except (json.JSONDecodeError, ValueError) as exc:
            await self._send_error(writer, 400, str(exc))
            return keep
        except FileNotFoundError as exc:
            await self._send_error(writer, 404, str(exc))
            return keep
        except PermissionError as exc:
            await self._send_error(writer, 403, str(exc))
            return keep
        except RuntimeError as exc:
            await self._send_error(writer, 503, str(exc))
            return False
        except ConnectionError:
            # Socket-level (this connection's writes): the loop owns cleanup.
            # Deliberately NOT OSError — backend I/O failures are OSError
            # subclasses and must become error *responses*, not silent drops.
            raise
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - wire boundary
            self.stats.bump("errors")
            try:
                await self._send_error(writer, 500, "%s: %s" % (type(exc).__name__, exc))
            except (ConnectionError, OSError):
                pass
            return False

    async def _dispatch_archives(
        self, req: _Request, writer, parts, tenant: str, keep: bool
    ) -> bool:
        if len(parts) == 2 and req.method == "POST":
            return await self._open_archive(req, writer, tenant, keep)
        if len(parts) < 3:
            await self._send_error(writer, 404, "no such route: %s" % req.path)
            return keep
        handle = parts[2]
        owner = self._tenant_of.get(handle)
        if self.admission.tokens and owner is not None and owner != tenant:
            # Handles are tenant-scoped capabilities: another tenant's
            # handle id is indistinguishable from an unknown one. Only
            # enforced on authenticated gateways — without tokens every
            # request resolves to default_tenant, so an open-time tenant
            # override (benchmark accounting) must not lock the opener out
            # of its own handle.
            raise KeyError("unknown or closed handle %r" % handle)
        if len(parts) == 3 and req.method == "DELETE":
            await self._asrv.close(handle)
            self._tenant_of.pop(handle, None)
            await self._send(writer, 204)
            return keep
        if len(parts) == 4 and parts[3] == "bytes" and req.method in ("GET", "HEAD"):
            return await self._serve_bytes(req, writer, handle, tenant, keep)
        if len(parts) == 4 and parts[3] == "stat" and req.method == "GET":
            stat = await self._asrv.stat(handle)
            etag = '"%s"' % (stat.identity or handle)[:32]
            inm = req.headers.get("if-none-match")
            if inm is not None and _etag_matches(inm, etag):
                self.stats.bump("not_modified_304")
                await self._send(writer, 304, {"ETag": etag})
                return keep
            await self._send_json(writer, 200, stat.as_dict(), {"ETag": etag})
            return keep
        if len(parts) == 4 and parts[3] == "index" and req.method in ("GET", "HEAD"):
            return await self._serve_index(req, writer, handle, keep)
        await self._send_error(writer, 405, "%s not supported on %s" % (req.method, req.path))
        return keep

    async def _open_archive(self, req: _Request, writer, tenant: str, keep: bool) -> bool:
        spec = json.loads(req.body.decode() or "{}")
        source = spec.get("source")
        if not isinstance(source, str) or not source:
            raise ValueError("POST /v1/archives requires a JSON body with 'source'")
        if self.admission.tokens:
            if "tenant" in spec:
                raise ValueError("tenant is derived from the bearer token")
        elif isinstance(spec.get("tenant"), str):
            tenant = spec["tenant"]  # unauthenticated deployments (benchmarks)
        self._check_source(source)
        handle = await self._asrv.open(
            source, tenant=tenant, quantum=self.admission.quantum_for(tenant)
        )
        self._tenant_of[handle] = tenant
        self.stats.bump("opened")
        await self._send_json(
            writer, 201,
            {"handle": handle, "tenant": tenant,
             "bytes_url": "/v1/archives/%s/bytes" % handle},
        )
        return keep

    def _check_source(self, source: str) -> None:
        if is_remote_url(source):
            if not self.allow_remote_sources:
                raise PermissionError("remote sources are disabled on this gateway")
            return
        if self.open_roots is None:
            return
        real = os.path.realpath(source)
        for root in self.open_roots:
            if real == root or real.startswith(root.rstrip(os.sep) + os.sep):
                return
        raise PermissionError("source outside the gateway's open_roots jail")

    # ------------------------------------------------------------------
    # the index-exchange endpoint
    # ------------------------------------------------------------------

    async def _serve_index(self, req: _Request, writer, handle: str, keep: bool) -> bool:
        """``GET /v1/archives/{h}/index`` — the finalized seek-index blob.

        ``{h}`` is either a live handle or a 64-hex ``file_identity`` store
        key: peers fetching across nodes only know the content-addressed key
        (they never saw this node's handle ids). The response ETag is the
        bare key, which is how the fetching side validates it got the index
        of the exact file version it asked about. 404 until the index is
        finalized — a speculative (unconfirmed) index must not propagate.
        """
        if _is_key(handle):
            blob = self._sync.index_store.get_blob(handle)
            pair = (handle, blob) if blob is not None else None
        else:
            pair = self._sync.index_blob(handle)  # KeyError -> 404 upstream
        if pair is None:
            await self._send_error(
                writer, 404, "no finalized index for %r" % handle
            )
            return keep
        key, blob = pair
        etag = '"%s"' % key
        headers = {"ETag": etag, "Content-Type": "application/octet-stream"}
        inm = req.headers.get("if-none-match")
        if inm is not None and _etag_matches(inm, etag):
            self.stats.bump("not_modified_304")
            await self._send(writer, 304, {"ETag": etag})
            return keep
        self.stats.bump("index_served")
        await self._send(
            writer, 200, headers, blob,
            head_only=req.method == "HEAD", content_length=len(blob),
        )
        return keep

    # ------------------------------------------------------------------
    # the bytes endpoint
    # ------------------------------------------------------------------

    async def _serve_bytes(
        self, req: _Request, writer, handle: str, tenant: str, keep: bool
    ) -> bool:
        try:
            # Warm handles answer from the lock-free stat (no bridge
            # round-trip); only a cold/unfinalized handle pays the bridged
            # size() that drives the speculative first pass.
            stat = await self._asrv.stat(handle)
            size = stat.decompressed_size
            if size is None:
                size = await self._asrv.size(handle)
                stat = await self._asrv.stat(handle)  # identity known now
            etag = '"%s"' % (stat.identity or handle)[:32]
            base_headers = {"ETag": etag, "Accept-Ranges": "bytes"}

            inm = req.headers.get("if-none-match")
            if inm is not None and _etag_matches(inm, etag):
                # Conditional revalidation (e.g. FleetClient confirming a
                # failover target serves the same object version): no body,
                # no backend read.
                self.stats.bump("not_modified_304")
                await self._send(writer, 304, base_headers)
                return keep

            rng = _parse_range(req.headers.get("range"), size)
            if_range = req.headers.get("if-range")
            if if_range is not None and if_range != etag:
                rng = None  # validator moved on: serve the full current body
            if rng == "unsat":
                await self._send(
                    writer, 416,
                    {**base_headers, "Content-Range": "bytes */%d" % size},
                )
                return keep
            if rng is None or rng == "invalid":
                start, stop, status = 0, size, 200
            else:
                start, stop = rng
                status = 206
                base_headers["Content-Range"] = "bytes %d-%d/%d" % (
                    start, stop - 1, size
                )
            span = stop - start
            self.stats.bump("reads")
            if req.method == "HEAD":
                await self._send(
                    writer, status, base_headers, head_only=True,
                    content_length=span,
                )
                return keep
            # Byte-rate admission: charge the whole span up front, before
            # any header goes out — a refusal propagates to _dispatch's 429
            # + Retry-After path on a still-clean connection. HEAD and 304
            # answered above stream nothing and are never charged.
            self.admission.charge_bytes(tenant, span)
            if span <= self.stream_span:
                data = await self._asrv.read_range(handle, start, span)
                await self._send(writer, status, base_headers, data)
                self.stats.served(tenant, len(data))
                return keep
            # Large span: chunked streaming, one bounded read per await so a
            # disconnect cancels at most one stream_span of in-flight work.
            self.stats.bump("streams")
            base_headers["Transfer-Encoding"] = "chunked"
            await self._send(writer, status, base_headers)
            sid = self.stats.stream_begin(handle, tenant, span)
            try:
                off = start
                while off < stop:
                    data = await self._asrv.read_range(
                        handle, off, min(self.stream_span, stop - off)
                    )
                    if not data:
                        break  # stale size claim: end the stream short but valid
                    writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
                    await self._drain(writer)
                    self.stats.served(tenant, len(data))
                    self.stats.stream_progress(sid, len(data))
                    off += len(data)
                writer.write(b"0\r\n\r\n")
                await self._drain(writer)
                return keep
            except (asyncio.CancelledError, ConnectionError):
                raise  # the function-level handlers below own these
            except Exception:  # noqa: BLE001 - wire framing boundary
                # Mid-stream failure *after* the response headers went out —
                # the handle DELETEd by another connection, or a backend I/O
                # error (OSError lands here too, on purpose): writing an
                # error response now would inject a status line into the
                # open chunked body and desync the framing. Abort: drop the
                # connection, never write.
                self.stats.bump("stream_aborts")
                return False
            finally:
                self.stats.stream_end(sid)
        except asyncio.CancelledError:
            # Client gone mid-request: the bridged await was already
            # cancelled by our own cancellation; also drop the speculation
            # the stream motivated (queued prefetches) if the handle is now
            # idle. Brief scheduler sweep — safe on the loop.
            self.stats.bump("cancelled_reads")
            try:
                self._sync.cancel_queued(handle)
            except Exception:  # noqa: BLE001 - handle may be gone already
                pass
            raise
        except ConnectionError:
            # A write on THIS socket failed (reset / stalled past the drain
            # timeout): same cleanup, then drop the connection — the
            # response is unfinishable. Backend I/O errors are NOT caught
            # here (plain OSError propagates to _dispatch's 404/403/500
            # mapping): a registered-but-missing file must answer 404, not
            # masquerade as a client disconnect.
            self.stats.bump("disconnects_mid_stream")
            try:
                self._sync.cancel_queued(handle)
            except Exception:  # noqa: BLE001
                pass
            return False
