"""FleetClient — the FileReader contract over a fleet of gateway peers.

A thin failover shell around `GatewayClient`: resolve the archive's owner
via the router, open there, delegate reads; on a peer fault, re-resolve,
re-open on the next-highest live peer, re-validate object identity, and
retry/resume. Positional reads make failover trivial (a pread re-issues
verbatim); streams resume at the exact byte offset already yielded via
``Range`` (see `GatewayClient.stream(offset=...)`).

Fault classification is deliberate: connection-level faults and gateway
5xx/timeout/throttle-exhaustion fail over (the peer, not the archive, is
the problem); 4xx management errors (404 unknown path, 403 jail) and
`RemoteFileChangedError` (the *file* changed — a different peer would only
confirm it) propagate immediately. Each logical operation tries each live
peer at most once; when every candidate is exhausted `FleetUnavailable`
(a `RemoteIOError`) surfaces, so existing remote-error handling upstream
needs no new except clauses.
"""

from __future__ import annotations

import http.client
import threading
from typing import Any, Dict, Iterator, Optional, Set

from ...core.errors import RemoteFileChangedError, RemoteIOError
from ...core.filereader import FileReader, check_pread_args
from ...obs import trace as _obs_trace
from ..gateway.client import GatewayClient, GatewayError


class FleetUnavailable(RemoteIOError):
    """No live peer can serve the archive (all candidates failed/ejected)."""


def _is_peer_failure(exc: BaseException) -> bool:
    """Faults that indict the *peer* (fail over) vs the *request* (raise)."""
    if isinstance(exc, RemoteFileChangedError):
        return False
    if isinstance(exc, GatewayError):
        # 429 only lands here after the client's retry budget is spent —
        # at that point the peer is effectively unavailable to us.
        return exc.status in (408, 429, 500, 502, 503, 504)
    return isinstance(exc, (RemoteIOError, OSError, http.client.HTTPException))


class FleetClient(FileReader):
    """Positioned reads of an archive's decompressed bytes via its fleet
    owner, with transparent failover.

    Built by `FleetRouter.open`; extra keyword arguments tune the inner
    `GatewayClient` / `RemoteFileReader` (block_size, cache_blocks,
    retry/backoff, timeout, retry_budget).
    """

    def __init__(
        self,
        router,
        source: str,
        *,
        token: Optional[str] = None,
        tenant: Optional[str] = None,
        **gateway_options: Any,
    ):
        self._router = router
        self._source = source
        self._token = token
        self._tenant = tenant
        self._gateway_options = gateway_options
        self._key = router.key_for(source)
        self._lock = threading.Lock()  # guards the (_peer, _gw) swap
        self._gw: Optional[GatewayClient] = None
        self._peer: Optional[str] = None
        self._etag: Optional[str] = None
        self._closed = False
        self.stats: Dict[str, int] = {
            "opens": 0, "failovers": 0, "revalidations": 0,
            "resumed_streams": 0,
        }
        self._connect(set())

    # -- placement / failover ------------------------------------------------

    @property
    def peer(self) -> Optional[str]:
        """URL of the peer currently serving this archive."""
        with self._lock:
            return self._peer

    @property
    def key(self) -> str:
        """Placement key (content-addressed `file_identity`) for this archive."""
        return self._key

    def _bump(self, counter: str) -> None:
        self.stats[counter] += 1
        self._router.note(counter)

    def _connect(self, exclude: Set[str]) -> GatewayClient:
        """Open the archive on the best live peer not in ``exclude``.

        On success the (peer, client) pair is installed under the lock; on a
        per-peer fault the peer is reported to membership and the next
        candidate tried. Raises `FleetUnavailable` when no candidate works.
        """
        last_exc: Optional[BaseException] = None
        for peer in self._router.owners(self._key):
            if peer in exclude:
                continue
            gw = None
            try:
                gw = GatewayClient(
                    peer,
                    source=self._source,
                    token=self._token,
                    tenant=self._tenant,
                    **self._gateway_options,
                )
                if self._etag is not None and gw.etag != self._etag:
                    # Re-validation after failover: the 304 path (a
                    # conditional GET inside revalidate) confirms version
                    # identity without refetching any body bytes.
                    self._bump("revalidations")
                    if not gw.revalidate(self._etag):
                        raise RemoteFileChangedError(
                            "%s: peer %s serves ETag %s, expected %s"
                            % (self._source, peer, gw.etag, self._etag)
                        )
            except BaseException as exc:
                if gw is not None:
                    try:
                        gw.close()
                    except Exception:  # noqa: BLE001 - already failing
                        pass
                if not _is_peer_failure(exc):
                    raise
                last_exc = exc
                exclude.add(peer)
                self._router.membership.report_failure(peer, exc)
                continue
            with self._lock:
                self._peer = peer
                self._gw = gw
                if self._etag is None:
                    self._etag = gw.etag
            self._bump("opens")
            return gw
        raise FleetUnavailable(
            "no live peer can serve %r (key %s): last error: %r"
            % (self._source, self._key[:12], last_exc)
        ) from last_exc

    def _current(self) -> GatewayClient:
        with self._lock:
            if self._closed:
                raise ValueError("operation on closed FleetClient")
            assert self._gw is not None
            return self._gw

    def _failover(self, failed: GatewayClient, exclude: Set[str]) -> None:
        """Replace ``failed`` with a client on the next-best peer.

        Concurrent preads may fail on the same dead peer at once: only the
        first caller performs the re-resolve; the rest observe the swap and
        simply retry on the new client.
        """
        with self._lock:
            if self._closed:
                raise ValueError("operation on closed FleetClient")
            if self._gw is not failed:
                return  # another thread already failed over
            peer = self._peer
        if peer is not None:
            exclude.add(peer)
            self._router.membership.report_failure(peer)
        try:
            failed.close()
        except Exception:  # noqa: BLE001 - the peer is gone; best effort
            pass
        self._bump("failovers")
        self._connect(exclude)

    # -- FileReader contract -------------------------------------------------

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        exclude: Set[str] = set()
        with _obs_trace.span("fleet.pread", {"offset": offset, "size": size}) as sp:
            while True:
                gw = self._current()
                try:
                    return gw.pread(offset, size)
                except BaseException as exc:
                    if not _is_peer_failure(exc):
                        raise
                    with _obs_trace.span(
                        "fleet.failover", {"from_peer": self.peer, "error": type(exc).__name__}
                    ):
                        self._failover(gw, exclude)  # raises FleetUnavailable at end
                    sp.set_attr("failovers", len(exclude))

    def size(self) -> int:
        exclude: Set[str] = set()
        while True:
            gw = self._current()
            try:
                return gw.size()
            except BaseException as exc:
                if not _is_peer_failure(exc):
                    raise
                self._failover(gw, exclude)

    def identity(self) -> Optional[str]:
        return self._current().identity()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            gw, self._gw = self._gw, None
        if gw is not None:
            gw.close()

    # -- fleet extras --------------------------------------------------------

    @property
    def etag(self) -> Optional[str]:
        return self._etag

    def stream(self, *, read_size: int = 64 << 10) -> Iterator[bytes]:
        """Yield the whole decompressed body; survives owner death.

        Bytes already yielded are never re-yielded: on a mid-stream peer
        fault the stream resumes on the failover peer at the exact next
        offset (``Range: bytes=offset-``), with ETag continuity enforced by
        `GatewayClient.stream` — the concatenation is bit-identical to an
        uninterrupted read.
        """
        offset = 0
        exclude: Set[str] = set()
        while True:
            gw = self._current()
            try:
                if offset and offset >= gw.size():
                    return  # failed over exactly at EOF
                for chunk in gw.stream(read_size=read_size, offset=offset):
                    offset += len(chunk)
                    yield chunk
                return
            except BaseException as exc:
                if not _is_peer_failure(exc):
                    raise
                self._failover(gw, exclude)
                if offset:
                    self._bump("resumed_streams")

    def stat(self) -> Dict[str, Any]:
        return self._current().stat()
