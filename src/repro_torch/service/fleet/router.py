"""FleetRouter — rendezvous-hash placement over live gateway peers.

Rendezvous (highest-random-weight) hashing beats a hash ring here because
the peer count is small and churn is the common case being optimized:
scoring is O(peers) per key with no virtual-node tuning, every client
agrees on the full preference order (not just the owner — the *failover
order* is part of the placement), and a peer's death moves exactly the
keys it owned to their next-highest peers.

The score is ``sha256(peer || key)`` truncated to 64 bits — stable across
processes and Python versions (never ``hash()``, which is salted per
process and would give every client its own placement).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..index_store import file_identity
from .membership import FleetMembership


def rendezvous_score(key: str, peer: str) -> int:
    """Deterministic 64-bit HRW score for (key, peer)."""
    h = hashlib.sha256()
    h.update(peer.encode())
    h.update(b"\0")
    h.update(key.encode())
    return int.from_bytes(h.digest()[:8], "big")


def rendezvous_rank(key: str, peers: Sequence[str]) -> List[str]:
    """Peers ordered by descending HRW score: [owner, first failover, ...].

    The peer URL is the tiebreak (scores are 64-bit, collisions are
    astronomically unlikely, but determinism must not rest on luck).
    """
    return sorted(
        peers, key=lambda p: (rendezvous_score(key, p), p), reverse=True
    )


class FleetRouter:
    """Client-side routing tier over N gateway peers.

    Owns a `FleetMembership` (or wraps one the caller provides) and places
    archives on live peers by HRW hash of their `file_identity` key.
    ``open()`` returns a `FleetClient` bound to this router; the router is
    shared state (membership view + fleet counters), clients are cheap.
    """

    def __init__(
        self,
        peers: Optional[Sequence[str]] = None,
        *,
        membership: Optional[FleetMembership] = None,
        probe_interval: float = 1.0,
        eject_after: int = 2,
        probe_timeout: float = 2.0,
        token: Optional[str] = None,
    ):
        if (peers is None) == (membership is None):
            raise ValueError("pass exactly one of peers= or membership=")
        self.membership = (
            membership
            if membership is not None
            else FleetMembership(
                peers,
                probe_interval=probe_interval,
                eject_after=eject_after,
                timeout=probe_timeout,
                token=token,
            )
        )
        self._owns_membership = membership is None
        self.token = token
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    # -- placement -----------------------------------------------------------

    def key_for(self, source) -> str:
        """The placement key: `IndexStore.file_identity` of the source (a
        64-hex string passes through unchanged)."""
        if isinstance(source, str) and len(source) == 64 and all(
            c in "0123456789abcdef" for c in source
        ):
            return source
        return file_identity(source)

    def owners(self, key: str) -> List[str]:
        """Live peers in placement-preference order for ``key``."""
        return rendezvous_rank(key, self.membership.alive())

    def owner(self, key: str) -> str:
        ranked = self.owners(key)
        if not ranked:
            from .client import FleetUnavailable

            raise FleetUnavailable(
                "no live peer for key %s (fleet of %d, all ejected)"
                % (key[:12], len(self.membership.peers()))
            )
        return ranked[0]

    def open(self, source, **client_options: Any):
        """Open ``source`` on its owner; returns a `FleetClient`."""
        from .client import FleetClient

        client_options.setdefault("token", self.token)
        return FleetClient(self, source, **client_options)

    # -- telemetry -----------------------------------------------------------

    def note(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def snapshot(self) -> Dict[str, Any]:
        """Fleet-side metrics: membership states + routing counters. Shaped
        for `repro.service.metrics.format_summary` under the ``router`` key."""
        with self._lock:
            counters = dict(self._counters)
        return {"membership": self.membership.snapshot(), "counters": counters}

    def metrics(self) -> Dict[str, Any]:
        return {"router": self.snapshot()}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        self.membership.start()
        return self

    def close(self) -> None:
        if self._owns_membership:
            self.membership.close()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
