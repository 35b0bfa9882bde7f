"""Cross-node index exchange: fetch finalized seek indexes from fleet peers.

The fetching side of the gateway's ``GET /v1/archives/{key}/index``
endpoint, packaged as an `IndexStore` ``remote_fallback`` hook. Peers are
asked in HRW order for the key — the owner is the peer most likely to have
paid for (and persisted) the index — and the response is validator-checked
against the very key requested: the endpoint's ETag is the bare
content-addressed ``file_identity`` key, so a match proves the peer is
talking about the same file version, not merely the same path. (The store
then re-validates that the blob parses as a *finalized* GzipIndex before
installing it.)

Single-flight de-duplication lives in `IndexStore` itself; this module is a
pure fetch function so it composes with any membership source: a static
URL list, a `FleetMembership`, or a `FleetRouter`.
"""

from __future__ import annotations

import http.client
import urllib.parse
from typing import Callable, Iterable, Optional, Sequence, Union

from .router import rendezvous_rank


def fetch_index_from_peers(
    peers: Sequence[str],
    key: str,
    *,
    token: Optional[str] = None,
    timeout: float = 5.0,
) -> Optional[bytes]:
    """Ask ``peers`` (in HRW order for ``key``) for the finalized index blob.

    Returns the first validator-matching blob, or None when no peer has one
    (every peer answered 404, errored, or served a mismatched ETag). Peer
    faults are swallowed: a missing index degrades to a cold first pass,
    it must never fail the open.
    """
    headers = {"Authorization": "Bearer %s" % token} if token else {}
    for peer in rendezvous_rank(key, [p.rstrip("/") for p in peers]):
        split = urllib.parse.urlsplit(peer)
        cls = (
            http.client.HTTPSConnection
            if split.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(split.netloc, timeout=timeout)
        try:
            conn.request(
                "GET", "/v1/archives/%s/index" % key, headers=dict(headers)
            )
            resp = conn.getresponse()
            blob = resp.read()
            if resp.status != 200:
                continue
            etag = (resp.getheader("ETag") or "").strip('"')
            if etag != key:
                # The peer is serving *an* index but not provably the one
                # for this exact file version — importing it could seed
                # corrupt seek points. Skip.
                continue
            return blob
        except (OSError, http.client.HTTPException):
            continue
        finally:
            conn.close()
    return None


def make_index_fallback(
    peers: Union[Sequence[str], "object"],
    *,
    exclude: Iterable[str] = (),
    token: Optional[str] = None,
    timeout: float = 5.0,
) -> Callable[[str], Optional[bytes]]:
    """Build an ``IndexStore(remote_fallback=...)`` hook over ``peers``.

    ``peers`` is a static URL sequence or anything with ``alive()`` (a
    `FleetMembership`/`FleetRouter.membership`) — the live view is consulted
    per fetch, so ejected peers are skipped. ``exclude`` is typically the
    node's *own* URL: a gateway must not ask itself for the index it is in
    the middle of missing.
    """
    excluded = {u.rstrip("/") for u in exclude}

    def fallback(key: str) -> Optional[bytes]:
        alive = getattr(peers, "alive", None)
        candidates = alive() if callable(alive) else list(peers)
        candidates = [
            u.rstrip("/") for u in candidates if u.rstrip("/") not in excluded
        ]
        if not candidates:
            return None
        return fetch_index_from_peers(
            candidates, key, token=token, timeout=timeout
        )

    return fallback
