"""FleetMembership — peer liveness from the metrics endpoint every peer
already serves.

No gossip, no heartbeat protocol: ``GET /v1/metrics`` is admission-exempt
(an overloaded gateway still answers it) and already carries per-handle
stream progress, so one poll yields both liveness and stuck-stream
detection. A peer is ejected after ``eject_after`` *consecutive* failures
(one dropped packet must not reshuffle placements) and re-admitted on its
first successful probe — rendezvous hashing then moves exactly its keys
back, nothing else.

Data-path failures count too: `FleetClient.report_failure` feeds the same
consecutive-failure counter, so a dead peer discovered by a read is ejected
without waiting for the next probe cycle to notice.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence


class PeerState:
    """Mutable health record for one peer (guarded by the membership lock)."""

    __slots__ = (
        "url", "alive", "consecutive_failures", "probes", "ejections",
        "readmissions", "last_ok", "last_error", "stuck_streams",
        "_last_stream_progress",
    )

    def __init__(self, url: str):
        self.url = url
        self.alive = True  # optimistic: a fresh fleet serves immediately
        self.consecutive_failures = 0
        self.probes = 0
        self.ejections = 0
        self.readmissions = 0
        self.last_ok: Optional[float] = None
        self.last_error: Optional[str] = None
        self.stuck_streams = 0
        # stream-id -> bytes sent at the previous probe (stuck detection)
        self._last_stream_progress: Dict[str, int] = {}

    def as_dict(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "alive": self.alive,
            "consecutive_failures": self.consecutive_failures,
            "probes": self.probes,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "last_ok": self.last_ok,
            "last_error": self.last_error,
            "stuck_streams": self.stuck_streams,
        }


def _default_probe(timeout: float, headers: Mapping[str, str]):
    def probe(url: str) -> Mapping[str, Any]:
        split = urllib.parse.urlsplit(url)
        cls = (
            http.client.HTTPSConnection
            if split.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(split.netloc, timeout=timeout)
        try:
            conn.request("GET", "/v1/metrics", headers=dict(headers))
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise OSError("HTTP %d from %s/v1/metrics" % (resp.status, url))
            return json.loads(body.decode())
        finally:
            conn.close()

    return probe


class FleetMembership:
    """Liveness view over a static peer set, probed at ``probe_interval``.

    ``probe`` is injectable (a callable ``url -> metrics dict``, raising on
    failure) so tests drive state transitions deterministically; the default
    probe speaks HTTP to ``/v1/metrics``. ``start()`` launches the daemon
    probe thread; `probe_once` is public for deterministic single steps.
    """

    def __init__(
        self,
        peers: Sequence[str],
        *,
        probe_interval: float = 1.0,
        eject_after: int = 2,
        timeout: float = 2.0,
        token: Optional[str] = None,
        probe: Optional[Callable[[str], Mapping[str, Any]]] = None,
    ):
        urls = [u.rstrip("/") for u in peers]
        if not urls:
            raise ValueError("a fleet needs at least one peer")
        if len(set(urls)) != len(urls):
            raise ValueError("duplicate peer URLs: %r" % (urls,))
        if eject_after < 1:
            raise ValueError("eject_after must be >= 1")
        self.probe_interval = probe_interval
        self.eject_after = eject_after
        headers = {"Authorization": "Bearer %s" % token} if token else {}
        self._probe = probe if probe is not None else _default_probe(timeout, headers)
        self._lock = threading.Lock()
        self._peers: Dict[str, PeerState] = {u: PeerState(u) for u in urls}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- views ---------------------------------------------------------------

    def peers(self) -> List[str]:
        with self._lock:
            return list(self._peers)

    def alive(self) -> List[str]:
        with self._lock:
            return [u for u, st in self._peers.items() if st.alive]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            states = {u: st.as_dict() for u, st in self._peers.items()}
        return {
            "peers": states,
            "alive": sum(1 for st in states.values() if st["alive"]),
            "total": len(states),
            "eject_after": self.eject_after,
            "probe_interval": self.probe_interval,
        }

    # -- state transitions ---------------------------------------------------

    def report_failure(self, url: str, error: Optional[BaseException] = None) -> None:
        """Data-path failure signal (connection refused/reset on a read):
        same consecutive-failure bookkeeping as a failed probe."""
        self._mark_failure(url.rstrip("/"), repr(error) if error else "reported")

    def _mark_failure(self, url: str, error: str) -> None:
        with self._lock:
            st = self._peers.get(url)
            if st is None:
                return
            st.consecutive_failures += 1
            st.last_error = error
            if st.alive and st.consecutive_failures >= self.eject_after:
                st.alive = False
                st.ejections += 1

    def _mark_success(self, url: str, metrics: Mapping[str, Any]) -> None:
        streams = {}
        gateway = metrics.get("gateway")
        if isinstance(gateway, Mapping):
            streams = gateway.get("streams_in_progress") or {}
        with self._lock:
            st = self._peers.get(url)
            if st is None:
                return
            st.consecutive_failures = 0
            st.last_ok = time.monotonic()
            st.last_error = None
            if not st.alive:
                st.alive = True
                st.readmissions += 1
            # A stream whose byte count did not advance since the previous
            # probe is *stuck* (slow streams advance, stalled ones do not) —
            # the liveness signal a cumulative byte counter cannot give.
            stuck = 0
            progress: Dict[str, int] = {}
            for sid, info in streams.items():
                sent = int(info.get("sent", 0))
                progress[sid] = sent
                if sid in st._last_stream_progress and st._last_stream_progress[sid] == sent:
                    stuck += 1
            st.stuck_streams = stuck
            st._last_stream_progress = progress

    def probe_once(self) -> None:
        """One probe sweep over all peers (serial; each bounded by the probe
        timeout). Public so tests and callers can step deterministically."""
        for url in self.peers():
            with self._lock:
                st = self._peers.get(url)
                if st is not None:
                    st.probes += 1
            try:
                metrics = self._probe(url)
            except Exception as exc:  # noqa: BLE001 - any fault is a failure
                self._mark_failure(url, repr(exc))
            else:
                self._mark_success(url, metrics)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetMembership":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fleet-membership", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval):
            self.probe_once()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "FleetMembership":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
