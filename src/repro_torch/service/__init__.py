"""Archive service of the port: multi-file, multi-client random-access
decompression, with stage 2 on the server's own engine (``device="cuda"``
by default, ``device="cpu"`` for the kernels' plain versions).

Lifts the paper's single-reader cache/prefetch architecture (§3.2) to a
fleet: many `ParallelGzipReader`s behind one shared memory budget
(`CachePool`), one shared decompression thread pool with per-tenant fairness
(`FairExecutor`), a persistent seek-index store so repeat opens skip the
speculative first pass (`IndexStore`), and fleet-wide telemetry (`metrics`).

    from repro_torch.service import ArchiveServer, IndexStore

    with ArchiveServer(cache_budget_bytes=32 << 20,
                       index_store=IndexStore("/var/cache/rpgz")) as srv:
        h = srv.open("corpus-00.json.gz", tenant="search")
        page = srv.read_range(h, 10 << 20, 4096)

`read_range` is stateless and concurrent — N threads on one handle scale
without a shared cursor (see server.py's concurrency contract). For asyncio
services, `AsyncArchiveServer` bridges the same calls off the event loop:

    from repro_torch.service import AsyncArchiveServer

    async with AsyncArchiveServer(cache_budget_bytes=32 << 20) as srv:
        h = await srv.open("corpus-00.json.gz", tenant="search")
        pages = await srv.read_many([(h, off, 4096) for off in offsets])

For network clients, the `gateway` subpackage puts all of this behind an
HTTP/1.1 wire protocol (range reads, chunked streaming, cancellation
propagation, per-tenant admission control) with a FileReader-shaped client:

    from repro_torch.service.gateway import GatewayServer, GatewayClient

    with GatewayServer(cache_budget_bytes=32 << 20) as gw:
        page = GatewayClient(gw.url, source="corpus-00.json.gz").pread(0, 4096)

One gateway is one machine's ceiling; the `fleet` subpackage shards
archives across N gateway peers by rendezvous hashing of file identity,
with health-probe membership, mid-stream failover via exact Range resume,
and cross-node seek-index exchange (a cold open on one node imports the
index another node already built):

    from repro_torch.service.fleet import FleetRouter

    with FleetRouter([gw1.url, gw2.url, gw3.url]) as router:
        page = router.open("corpus-00.json.gz").pread(0, 4096)
"""

from .async_server import AsyncArchiveServer
from .cache_pool import ACCESS, PREFETCH, CachePool, PooledCache, TenantStats, default_size_of
from .index_store import IndexStore, IndexStoreStats, file_identity
from .metrics import aggregate_reader_reports, collect, format_summary
from .scheduler import FairExecutor, TenantExecutor
from .server import ArchiveServer, ArchiveStat
from .gateway import (  # noqa: E402 - gateway builds on the modules above
    AdmissionDenied,
    GatewayClient,
    GatewayError,
    GatewayServer,
    TenantAdmission,
)
from .fleet import (  # noqa: E402 - fleet builds on the gateway
    FleetClient,
    FleetMembership,
    FleetRouter,
    FleetUnavailable,
    make_index_fallback,
)

__all__ = [
    "ACCESS",
    "PREFETCH",
    "AdmissionDenied",
    "ArchiveServer",
    "ArchiveStat",
    "AsyncArchiveServer",
    "CachePool",
    "FairExecutor",
    "FleetClient",
    "FleetMembership",
    "FleetRouter",
    "FleetUnavailable",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "TenantAdmission",
    "IndexStore",
    "IndexStoreStats",
    "PooledCache",
    "TenantExecutor",
    "TenantStats",
    "aggregate_reader_reports",
    "collect",
    "default_size_of",
    "file_identity",
    "format_summary",
    "make_index_fallback",
]
