"""Sharded archive fleet: routing, failover, and cross-node index exchange.

One gateway process is the ceiling of PRs 1-5 — a single event loop, one
machine's cores, one cache budget. This package is the horizontal axis the
ROADMAP's north star requires: N independent gateway peers behind a thin
client-side routing tier. Nothing here adds a coordinator process or a
consensus protocol; placement is a pure function of content identity, and
every recovery path reduces to wire primitives the gateway already
guarantees (exact Range semantics, ETag validators, admission Retry-After).

Placement contract
==================

Archives are placed by **rendezvous (HRW) hashing** of their
`IndexStore.file_identity` key: for each (key, peer) pair a deterministic
score ``sha256(peer || key)`` is computed, and the key's *owner* is the
live peer with the highest score (`rendezvous_rank` returns the full
preference order). Properties the fleet leans on:

  * **Coordinator-free agreement** — every client computes the same owner
    from the same membership view; no lookup table, no rebalancing state.
  * **Minimal disruption** — when a peer dies, only the keys it owned move
    (each to its next-highest peer); all other placements are untouched.
    When it recovers, exactly those keys move back.
  * **Content-addressed** — the key is `file_identity` (path+size+mtime,
    content digest, or url+validator), the same key the `IndexStore` uses,
    so "where does this archive live" and "where is its seek index" have
    the same answer by construction.

Failover contract
=================

`FleetClient` speaks the `FileReader` contract (pread/size/identity/view/
close) against the archive's owner. On a peer fault mid-operation it:

  1. reports the failure to `FleetMembership` (probes will eject the peer
     after ``eject_after`` consecutive failures; data-path reports count),
  2. re-resolves to the next-highest live peer, excluding peers already
     tried for this operation,
  3. re-opens the archive there and **re-validates object identity** with a
     conditional GET (``If-None-Match``: a 304 proves the new peer serves
     the same object version for the price of headers — satisfying the
     "no full-body refetch on failover" budget),
  4. resumes: a pread simply re-issues (positional reads are stateless); a
     ``stream()`` resumes at the exact byte offset already yielded via
     ``Range: bytes=offset-``, with ETag continuity enforced — killing the
     owner mid-stream yields bit-identical bytes to an uninterrupted read.

Membership and health come from polling each peer's existing
``/v1/metrics`` endpoint (admission-exempt, so an overloaded peer still
answers): configurable probe interval, consecutive-failure ejection,
re-admission on the first successful probe after recovery. Per-handle
stream progress in the metrics lets probes distinguish a *stuck* peer
(bytes frozen across probes) from a merely slow stream.

Index exchange
==============

The expensive artifact worth sharing across nodes is the finalized seek
index — rebuilding it re-runs the speculative first pass over the whole
file (O(file)), while shipping it costs O(index). The gateway's
``GET /v1/archives/{key}/index`` endpoint serves finalized index blobs by
content-addressed key; `make_index_fallback` builds the `IndexStore`
remote-fallback hook that asks fleet peers (in HRW order — the owner most
likely has it) on a local miss. Fetches are single-flighted per key and
validator-checked twice: the response ETag must equal the requested key,
and the blob must parse as a *finalized* `GzipIndex`. A cold open on node
B of an archive node A already indexed therefore does **zero** speculative
first-pass work — fleet-wide warm-open cost drops from O(file) to
O(index).

Quickstart (see ``examples/serve_fleet.py`` for the full tour)::

    from repro.service.fleet import FleetRouter

    with FleetRouter([gw1.url, gw2.url, gw3.url]) as router:
        client = router.open("/data/corpus-00.json.gz")
        page = client.pread(10 << 20, 4096)   # served by the HRW owner
        for chunk in client.stream():          # survives owner death
            consume(chunk)
        client.close()
"""

from .client import FleetClient, FleetUnavailable
from .exchange import fetch_index_from_peers, make_index_fallback
from .membership import FleetMembership, PeerState
from .router import FleetRouter, rendezvous_rank, rendezvous_score

__all__ = [
    "FleetClient",
    "FleetMembership",
    "FleetRouter",
    "FleetUnavailable",
    "PeerState",
    "fetch_index_from_peers",
    "make_index_fallback",
    "rendezvous_rank",
    "rendezvous_score",
]
