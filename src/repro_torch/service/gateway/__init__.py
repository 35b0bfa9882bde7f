"""Network gateway: the archive service behind an HTTP/1.1 wire protocol.

PRs 1-4 built a multi-tenant archive service that was only reachable
in-process. This package is the wire front-end the ROADMAP's north star
(heavy traffic from millions of users) requires: a dependency-free
HTTP/1.1 server (stdlib ``asyncio`` sockets — hermetic, loopback-testable
like ``tests/_range_server.py``) over `AsyncArchiveServer`, plus a
`FileReader`-shaped client, so every byte of the paper's architecture
(speculative parallel decompression, shared cache budget, fair scheduling,
persistent seek indexes) is now one ``Range:`` header away from any HTTP
client.

Wire protocol (all request/response bodies JSON unless noted):

    ==========  =================================  =============================
    verb        path                               semantics
    ==========  =================================  =============================
    POST        /v1/archives                       open ``{"source": path|url}``
                                                   -> 201 ``{"handle", "tenant"}``
    HEAD        /v1/archives/{h}/bytes             decompressed stat: 200 with
                                                   ``Content-Length`` (size),
                                                   ``ETag`` (from
                                                   IndexStore.file_identity),
                                                   ``Accept-Ranges: bytes``
    GET         /v1/archives/{h}/bytes             decompressed bytes.
                                                   ``Range: bytes=a-b`` (also
                                                   ``a-`` and suffix ``-n``)
                                                   -> 206 + ``Content-Range``;
                                                   no Range -> 200 full stream;
                                                   start past EOF -> 416 with
                                                   ``Content-Range: bytes */N``.
                                                   Spans larger than the
                                                   gateway's ``stream_span``
                                                   stream chunked
                                                   (``Transfer-Encoding``).
    GET         /v1/archives/{h}/stat              JSON `ArchiveStat` (+ETag;
                                                   ``If-None-Match`` -> 304)
    GET         /v1/archives/{h}/index             finalized seek-index blob
                                                   (binary GzipIndex). ``{h}``
                                                   is a handle **or** a 64-hex
                                                   ``file_identity`` key;
                                                   ``ETag`` is the bare key.
                                                   404 until finalized.
    DELETE      /v1/archives/{h}                   close -> 204
    GET         /v1/metrics                        fleet metrics + gateway/
                                                   bridge/admission sections
                                                   (incl. per-handle stream
                                                   progress)
    ==========  =================================  =============================

    ``GET``/``HEAD`` on ``/bytes`` and ``/stat`` honor ``If-None-Match``
    (ETag revalidation -> ``304 Not Modified``), which lets a fleet client
    re-validate a failover target for the cost of headers, not a body.

The ``/bytes`` endpoint deliberately speaks the exact single-range dialect
`core.remote.RemoteFileReader` consumes (206/416, ``Content-Range``,
``ETag`` + ``If-Range``), so gateways *chain*: a second-tier gateway can
``open()`` a first-tier gateway's bytes URL like any other remote object —
tiered deployments for free, and one contract suite covers both hops.

Three front-end properties the in-process API could not offer:

  * **Cancellation propagation** — a client disconnecting mid-stream
    cancels the handler's in-flight `AsyncArchiveServer` awaits (bridged
    futures are cancelled before they can occupy a bridge thread) and
    sweeps the handle's queued FairExecutor prefetch backlog
    (`ArchiveServer.cancel_queued`); the executor books them under
    ``cancelled`` so ``submitted == done + cancelled + queued`` always
    balances — no orphaned decompression work.
  * **Per-tenant admission control** — `TenantAdmission` maps bearer
    tokens to tenants and bounds each tenant's in-flight requests and
    wait-queue depth; overflow is answered ``429 Too Many Requests`` with
    ``Retry-After``, so one cold-scanning tenant can no longer occupy
    every bridge thread.
  * **Service classes** — admission carries per-tenant weighted-DRR
    quantum factors (`FairExecutor.set_tenant_quantum`) and cache-share
    weights into the backing server.

Quickstart (see ``examples/serve_gateway.py`` for the full tour)::

    from repro.service.gateway import GatewayServer, GatewayClient

    with GatewayServer(cache_budget_bytes=64 << 20, max_workers=4) as gw:
        client = GatewayClient(gw.url, source="/data/corpus-00.json.gz")
        page = client.pread(10 << 20, 4096)     # FileReader contract
        for chunk in client.stream():            # chunked full read
            consume(chunk)
        client.close()
"""

from .admission import AdmissionDenied, TenantAdmission
from .client import GatewayClient, GatewayError
from .server import GatewayServer

__all__ = [
    "AdmissionDenied",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "TenantAdmission",
]
