"""repro_torch.service.fleet against the JAX package's fleet.

The fleet modules are byte-for-byte copies, so the unit tests mirror
``tests/test_fleet.py`` on the port's classes and hold rendezvous placement
equal to the reference's. The wire tests run a loopback fleet of port
gateways, each over its own ``ArchiveServer(device="cpu")`` and
``IndexStore`` with the stores cross-wired by ``make_index_fallback``.
Killing the owner with ``GatewayServer.close()`` while the router's client
holds its connection returns at once in the port, so the three failover
scenarios that fail in the reference (``test_fleet.py``'s kill mid-stream
and pread failover, ``test_obs.py``'s stitched trace) must pass here, with
bit-identical bytes. A mixed fleet holds the wire format of the index
exchange against the reference in both directions.
"""

import gzip
import hashlib
import threading
import time

import numpy as np
import pytest

import repro.service as ref_service
import repro.service.fleet as ref_fleet
from conftest import gzip_bytes, make_text
from repro.service.gateway import GatewayServer as RefGatewayServer
from repro_torch.core import GzipIndex, ParallelGzipReader
from repro_torch.obs import trace as obs_trace
from repro_torch.service import ArchiveServer, IndexStore
from repro_torch.service.fleet import (
    FleetMembership,
    FleetRouter,
    FleetUnavailable,
    fetch_index_from_peers,
    make_index_fallback,
    rendezvous_rank,
    rendezvous_score,
)
from repro_torch.service.gateway import GatewayClient, GatewayServer
from repro_torch.service.index_store import file_identity

pytestmark = pytest.mark.gateway

SERVER = dict(cache_budget_bytes=8 << 20, max_workers=2, chunk_size=128 << 10)


# ---------------------------------------------------------------------------
# rendezvous hashing: the reference's placement, determinism, minimal disruption
# ---------------------------------------------------------------------------

PEERS = ["http://10.0.0.%d:80" % i for i in range(1, 6)]
KEYS = [hashlib.sha256(str(i).encode()).hexdigest() for i in range(200)]


def test_rendezvous_score_is_sha256_derived_and_stable():
    key, peer = "a" * 64, "http://127.0.0.1:1234"
    h = hashlib.sha256(peer.encode() + b"\0" + key.encode()).digest()
    assert rendezvous_score(key, peer) == int.from_bytes(h[:8], "big")
    assert rendezvous_score(key, peer) == rendezvous_score(key, peer)


@pytest.mark.parametrize("n_peers", [1, 2, 5])
def test_rendezvous_matches_reference(n_peers):
    peers = PEERS[:n_peers]
    for key in KEYS:
        assert [rendezvous_score(key, p) for p in peers] == [
            ref_fleet.rendezvous_score(key, p) for p in peers
        ]
        assert rendezvous_rank(key, peers) == ref_fleet.rendezvous_rank(key, peers)


def test_rendezvous_rank_minimal_disruption():
    before = {k: rendezvous_rank(k, PEERS) for k in KEYS}
    assert all(rendezvous_rank(k, list(reversed(PEERS))) == before[k] for k in KEYS)
    dead = PEERS[2]
    after = {k: rendezvous_rank(k, [p for p in PEERS if p != dead]) for k in KEYS}
    for k in KEYS:
        assert after[k] == [p for p in before[k] if p != dead]
    moved = sum(1 for k in KEYS if before[k][0] == dead)
    assert 0 < moved < len(KEYS)


def test_router_key_for_hex_passthrough_and_identity(tmp_path):
    router = FleetRouter(["http://127.0.0.1:1"])
    key = "f" * 64
    assert router.key_for(key) == key
    p = tmp_path / "x.gz"
    p.write_bytes(gzip.compress(b"hello"))
    assert router.key_for(str(p)) == file_identity(str(p)) == ref_service.file_identity(str(p))
    router.close()


def test_router_requires_exactly_one_of_peers_or_membership():
    with pytest.raises(ValueError):
        FleetRouter()
    with pytest.raises(ValueError):
        FleetRouter(["http://a"], membership=FleetMembership(["http://a"]))


# ---------------------------------------------------------------------------
# membership: ejection, re-admission, stuck streams (injected probe)
# ---------------------------------------------------------------------------

def test_membership_validation():
    with pytest.raises(ValueError):
        FleetMembership([])
    with pytest.raises(ValueError):
        FleetMembership(["http://a", "http://a/"])
    with pytest.raises(ValueError):
        FleetMembership(["http://a"], eject_after=0)


def test_membership_eject_and_readmit_with_injected_probe():
    up = {"http://a": True, "http://b": True}

    def probe(url):
        if not up[url]:
            raise OSError("down")
        return {"gateway": {"streams_in_progress": {}}}

    m = FleetMembership(["http://a", "http://b"], eject_after=2, probe=probe)
    assert sorted(m.alive()) == ["http://a", "http://b"]
    up["http://b"] = False
    m.probe_once()
    assert "http://b" in m.alive()
    m.probe_once()
    assert m.alive() == ["http://a"]
    snap = m.snapshot()["peers"]["http://b"]
    assert not snap["alive"] and snap["ejections"] == 1
    up["http://b"] = True
    m.probe_once()
    snap = m.snapshot()["peers"]["http://b"]
    assert snap["alive"] and snap["readmissions"] == 1
    assert snap["consecutive_failures"] == 0
    assert snap["probes"] == 3


def test_membership_data_path_failures_count_toward_ejection():
    m = FleetMembership(["http://a", "http://b"], eject_after=2)
    m.report_failure("http://a", OSError("reset"))
    assert "http://a" in m.alive()
    m.report_failure("http://a")
    assert m.alive() == ["http://b"]
    m.report_failure("http://nobody")
    assert m.peers() == ["http://a", "http://b"]


def test_membership_stuck_stream_detection():
    sent = {"7": 1000}

    def probe(url):
        return {"gateway": {"streams_in_progress": {
            k: {"handle": "f1", "tenant": "t", "sent": v, "total": 9999}
            for k, v in sent.items()
        }}}

    m = FleetMembership(["http://a"], probe=probe)
    m.probe_once()
    assert m.snapshot()["peers"]["http://a"]["stuck_streams"] == 0
    m.probe_once()
    assert m.snapshot()["peers"]["http://a"]["stuck_streams"] == 1
    sent["7"] = 2000
    m.probe_once()
    assert m.snapshot()["peers"]["http://a"]["stuck_streams"] == 0


# ---------------------------------------------------------------------------
# IndexStore remote fallback: validation + single flight
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def finalized_blob():
    """Serialized finalized index of a small corpus, written by the port's
    reader on the kernels' plain versions."""
    rng = np.random.default_rng(0x1D3)
    data = make_text(rng, 150_000)
    with ParallelGzipReader(gzip_bytes(data, 6), parallelization=2, chunk_size=32 << 10,
                            device="cpu") as r:
        assert r.read() == data
        assert r.index.finalized
        return r.index.to_bytes()


def test_index_store_fallback_installs_valid_blob(finalized_blob):
    calls = []

    def fallback(key):
        calls.append(key)
        return finalized_blob

    store = IndexStore(remote_fallback=fallback)
    key = "a" * 64
    idx = store.get(key)
    assert idx is not None and idx.finalized
    assert calls == [key]
    assert store.stats.remote_hits == 1 and store.stats.hits == 1
    assert store.get(key) is not None
    assert calls == [key]
    assert store.stats.hits == 2 and store.stats.remote_hits == 1


@pytest.mark.parametrize("raw", [None, b"", b"garbage", b"NOTANIDX" + b"\0" * 64])
def test_index_store_fallback_rejects_invalid_blobs(raw):
    store = IndexStore(remote_fallback=lambda key: raw)
    assert store.get("b" * 64) is None
    assert store.stats.misses == 1
    assert store.stats.remote_misses == 1 and store.stats.remote_hits == 0


def test_index_store_fallback_swallows_fetch_errors():
    def fallback(key):
        raise OSError("peer down")

    store = IndexStore(remote_fallback=fallback)
    assert store.get("c" * 64) is None
    assert store.stats.remote_misses == 1


def test_index_store_fallback_single_flight(finalized_blob):
    release = threading.Event()
    calls = []

    def fallback(key):
        calls.append(key)
        release.wait(timeout=10)
        return finalized_blob

    store = IndexStore(remote_fallback=fallback)
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(store.get("d" * 64)))
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    time.sleep(0.2)
    release.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert len(results) == 4 and all(r is not None for r in results)
    assert store.stats.remote_hits == 1


# ---------------------------------------------------------------------------
# wire fixtures: a loopback fleet of port gateways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    rng = np.random.default_rng(0x51A11)
    data = make_text(rng, 250_000)
    path = tmp_path_factory.mktemp("torch_fleet_small") / "small.gz"
    path.write_bytes(gzip_bytes(data, 6))
    return str(path), data


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """About 1.2 MB of text (190 KB of gzip). The owner is killed after
    256 KiB of the stream. Its first pass may be done by then, and loopback
    socket buffers can take the whole stream, so the kill mid-stream test
    gates the owner: its reads past ``OWNER_GATE`` wait until the test has
    killed it, and the rest of the stream must come from another peer."""
    rng = np.random.default_rng(0xF1EE7)
    data = make_text(rng, 1_200_000)
    path = tmp_path_factory.mktemp("torch_fleet_big") / "big.gz"
    path.write_bytes(gzip_bytes(data, 6))
    return str(path), data


@pytest.fixture
def fleet(tmp_path):
    """Factory: n port gateways (own ArchiveServer(device="cpu") and
    IndexStore each, cross-wired index fallbacks) behind a FleetRouter with
    eject_after=1. Every gateway, router and server is closed at teardown."""
    made = []

    def make(n=3, *, wire_exchange=True, **router_kwargs):
        stores, servers, gws = [], [], []
        for i in range(n):
            store = IndexStore(tmp_path / ("idx%d" % i))
            srv = ArchiveServer(device="cpu", index_store=store, **SERVER)
            servers.append(srv)
            gws.append(GatewayServer(srv, stream_span=64 << 10).start())
            stores.append(store)
        urls = [gw.url for gw in gws]
        if wire_exchange:
            for i, store in enumerate(stores):
                store.set_remote_fallback(make_index_fallback(urls, exclude=[urls[i]]))
        router_kwargs.setdefault("eject_after", 1)
        router = FleetRouter(urls, **router_kwargs)
        made.append((router, gws, servers))
        return router, gws, stores

    yield make
    for router, gws, servers in made:
        router.close()
        for gw in gws:
            gw.close()
        for srv in servers:
            srv.shutdown()


def _gw_for(gws, url):
    return next(gw for gw in gws if gw.url == url)


def _kill(gw):
    """Close ``gw`` as a peer dies: while clients hold their connections.
    It must return at once."""
    t0 = time.monotonic()
    gw.close()
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# placement on the wire
# ---------------------------------------------------------------------------

def test_fleet_routes_to_owner(fleet, small):
    path, data = small
    router, gws, _ = fleet()
    c = router.open(path)
    try:
        assert c.peer == router.owner(c.key)
        assert c.peer == ref_fleet.rendezvous_rank(c.key, [gw.url for gw in gws])[0]
        assert c.size() == len(data)
        assert c.pread(1234, 4096) == data[1234 : 1234 + 4096]
        for gw in gws:
            opened = gw.metrics()["gateway"].get("opened", 0)
            assert opened == (1 if gw.url == c.peer else 0)
    finally:
        c.close()
    assert router.snapshot()["counters"]["opens"] == 1


def test_fleet_unavailable_when_all_peers_dead(fleet, small):
    path, _ = small
    router, gws, _ = fleet(n=2)
    for url in router.membership.peers():
        router.membership.report_failure(url)
    with pytest.raises(FleetUnavailable):
        router.open(path)
    with pytest.raises(FleetUnavailable):
        router.owner("e" * 64)


# ---------------------------------------------------------------------------
# failover: kill the owner while the router's client holds its connection
# ---------------------------------------------------------------------------

#: The owner serves no byte past this offset of the stream until it is dead.
OWNER_GATE = 512 << 10


def _gate(server, at: int) -> threading.Event:
    """Hold ``server``'s reads that reach past ``at`` until the returned
    event is set (at most 60 s)."""
    opened = threading.Event()
    read_range = server.read_range

    def gated(handle, offset, size):
        if offset + size > at:
            opened.wait(60)
        return read_range(handle, offset, size)

    server.read_range = gated
    return opened


def test_kill_owner_mid_stream_failover_bit_identical(fleet, big):
    path, data = big
    router, gws, _ = fleet()
    c = router.open(path)
    owner = c.peer
    opened = _gate(_gw_for(gws, owner).server, OWNER_GATE)
    got, n, killed = [], 0, False
    deadline = time.monotonic() + 120
    try:
        for chunk in c.stream(read_size=64 << 10):
            got.append(chunk)
            n += len(chunk)
            if not killed and n >= 256 << 10:
                killed = True
                _kill(_gw_for(gws, owner))
                opened.set()
            assert time.monotonic() < deadline
    finally:
        opened.set()
    assert killed
    assert b"".join(got) == data
    assert c.stats["failovers"] >= 1
    assert c.stats["resumed_streams"] >= 1
    assert c.peer != owner
    assert c.pread(300_000, 8192) == data[300_000:308_192]
    router.membership.probe_once()
    snap = router.membership.snapshot()
    assert snap["alive"] == 2
    assert not snap["peers"][owner]["alive"]
    c.close()


def test_pread_failover_after_owner_death(fleet, small):
    path, data = small
    router, gws, _ = fleet()
    # A one-block client cache, so the read after the kill must hit the wire.
    c = router.open(path, block_size=16 << 10, cache_blocks=1)
    owner = c.peer
    assert c.pread(0, 1000) == data[:1000]
    _kill(_gw_for(gws, owner))
    assert c.pread(100_000, 1000) == data[100_000:101_000]
    assert c.pread(len(data) - 500, 500) == data[-500:]
    assert c.stats["failovers"] == 1
    assert c.peer != owner
    c.close()


@pytest.fixture
def tracing():
    obs_trace.disable_tracing()
    obs_trace.reset_tracing()
    yield obs_trace
    obs_trace.disable_tracing()
    obs_trace.reset_tracing()


def test_fleet_failover_yields_one_stitched_trace(fleet, tracing, tmp_path):
    rng = np.random.default_rng(0x0B5)
    data = make_text(rng, 300_000)
    router, gws, _ = fleet(wire_exchange=False)
    path = tmp_path / "stitch.gz"
    path.write_bytes(gzip_bytes(data, 6))
    tracing.enable_tracing()
    c = router.open(str(path), block_size=16 << 10, cache_blocks=1)
    owner = c.peer
    with tracing.span("client.session") as root:
        assert c.pread(0, 1000) == data[:1000]
        _kill(_gw_for(gws, owner))
        assert c.pread(150_000, 1000) == data[150_000:151_000]
    assert c.stats["failovers"] == 1
    assert c.peer != owner
    c.close()

    spans = tracing.recorded_spans()
    tree = [s for s in spans if s["trace_id"] == root.trace_id]
    names = {s["name"] for s in tree}
    assert {"fleet.pread", "fleet.failover", "remote.range_get"} <= names
    assert {"gateway.request", "gateway.admission_wait", "bridge.call", "executor.run",
            "reader.frontier_wait", "server.read_range"} <= names
    gw_reqs = [s for s in tree if s["name"] == "gateway.request"]
    assert len(gw_reqs) >= 2
    assert len({s["thread"] for s in gw_reqs}) >= 2
    ids = {s["span_id"] for s in tree}
    for g in gw_reqs:
        assert g["parent_id"] in ids
    trace = tracing.dump_trace(spans=tree)
    assert len(trace["traceEvents"]) >= len(tree)


def test_killed_peer_shuts_down_its_owned_engine(small):
    """A gateway that owns its server releases the server's engine when it
    is killed under a held connection, as the fleet kills peers."""
    path, data = small
    gws = [GatewayServer(device="cpu", stream_span=64 << 10, **SERVER).start() for _ in range(2)]
    router = FleetRouter([gw.url for gw in gws], eject_after=1)
    try:
        c = router.open(path, block_size=16 << 10, cache_blocks=1)
        owner = _gw_for(gws, c.peer)
        engine = owner.server.device_engine
        assert c.pread(5000, 4096) == data[5000:9096]
        _kill(owner)
        assert engine.stats()["closed"]
        assert c.pread(200_000, 4096) == data[200_000:204_096]
        assert c.stats["failovers"] == 1
        c.close()
    finally:
        router.close()
        for gw in gws:
            gw.close()


# ---------------------------------------------------------------------------
# cross-node index exchange
# ---------------------------------------------------------------------------

def test_index_exchange_makes_cold_open_warm(fleet, small):
    path, data = small
    router, gws, stores = fleet()
    c = router.open(path)
    owner = c.peer
    assert b"".join(c.stream()) == data
    c.close()
    key = file_identity(path)
    assert stores[[gw.url for gw in gws].index(owner)].get_blob(key) is not None

    other = next(gw for gw in gws if gw.url != owner)
    oi = [gw.url for gw in gws].index(other.url)
    g = GatewayClient(other.url, source=path)
    try:
        assert g.stat()["index_was_warm"] is True
        assert g.pread(5000, 4096) == data[5000 : 5000 + 4096]
        m = other.metrics()
        assert m["index_store"]["remote_hits"] == 1
        assert m["fleet"]["fetcher"]["nominal_tasks"] == 0
        assert m["fleet"]["frontier"]["lock_acquires"] == 0
        assert stores[oi].get_blob(key) is not None
    finally:
        g.close()


def test_index_endpoint_serves_blob_by_handle_and_key(fleet, small):
    path, data = small
    router, gws, _ = fleet(n=1)
    gw = gws[0]
    key = file_identity(path)
    g = GatewayClient(gw.url, source=path)
    try:
        assert b"".join(g.stream()) == data
        blob = g.fetch_index()
        assert blob is not None and GzipIndex.from_bytes(blob).finalized
    finally:
        g.close()
    got = fetch_index_from_peers([gw.url], key)
    assert got is not None and GzipIndex.from_bytes(got).finalized
    assert ref_fleet.fetch_index_from_peers([gw.url], key) == got
    assert fetch_index_from_peers([gw.url], "0" * 64) is None


def _ref_peer(store_dir):
    """A reference gateway over its own ArchiveServer and IndexStore."""
    store = ref_service.IndexStore(store_dir)
    srv = ref_service.ArchiveServer(index_store=store, **SERVER)
    return srv, RefGatewayServer(srv, stream_span=64 << 10).start(), store


def _port_peer(store_dir):
    store = IndexStore(store_dir)
    srv = ArchiveServer(device="cpu", index_store=store, **SERVER)
    return srv, GatewayServer(srv, stream_span=64 << 10).start(), store


@pytest.mark.parametrize("warm_from", ["reference", "port"])
def test_mixed_fleet_index_exchange(small, tmp_path, warm_from):
    """One peer of each package. The peer named ``warm_from`` reads the
    archive whole (its first pass) and persists the index on close; the
    other peer's IndexStore, wired to it by its own package's
    ``make_index_fallback``, opens the same archive warm: one remote hit,
    no first-pass task, the same bytes."""
    path, data = small
    makers = {"reference": (_ref_peer, ref_fleet.make_index_fallback),
              "port": (_port_peer, make_index_fallback)}
    cold_from = "port" if warm_from == "reference" else "reference"
    made = []
    try:
        made.append(makers[warm_from][0](str(tmp_path / "warm")))
        made.append(makers[cold_from][0](str(tmp_path / "cold")))
        (_, warm_gw, warm_store), (cold_srv, cold_gw, cold_store) = made
        cold_store.set_remote_fallback(makers[cold_from][1]([warm_gw.url]))
        g = GatewayClient(warm_gw.url, source=path)
        try:
            assert b"".join(g.stream()) == data
        finally:
            g.close()
        key = file_identity(path)
        assert warm_store.get_blob(key) is not None
        g = GatewayClient(cold_gw.url, source=path)
        try:
            assert g.stat()["index_was_warm"] is True
            assert g.pread(0, len(data)) == data
            m = cold_gw.metrics()
            assert m["index_store"]["remote_hits"] == 1
            assert m["fleet"]["fetcher"]["nominal_tasks"] == 0
        finally:
            g.close()
        assert cold_store.get_blob(key) == warm_store.get_blob(key)
    finally:
        for srv, gw, _ in made:
            gw.close()
            srv.shutdown()
