"""repro_torch.service against the JAX package's service tier.

The port's ``ArchiveServer(device="cpu")`` (stage 2 through the server's
own engine, running the kernels' plain versions) and the reference's
``repro.service.ArchiveServer`` serve the same archives: gzip, BGZF and
multi-member gzip. Bytes, ``stat``, index blobs, persisted indexes, the
shape of ``metrics()`` and a transcode to a BGZF twin must agree.

The second half holds the port to its own rules: ``device="cuda"`` raises
on a host without a card instead of serving on the CPU, and nothing in the
service tier reaches the process-wide ``shared_engine`` unless asked; the
engine in ``metrics()`` is the one that resolved every reader's stage 2.
"""

import asyncio

import numpy as np
import pytest
import torch

import repro.service as ref_service
from conftest import make_base64, make_text
from repro.core.synth import bgzf_compress, fixed_only_compress, gzip_compress, multistream_gzip
from repro_torch.core import GzipIndex, ParallelGzipReader
from repro_torch.kernels import engine as tengine
from repro_torch.kernels.engine import TorchDecodeEngine
from repro_torch.service import ArchiveServer, AsyncArchiveServer, IndexStore, file_identity
from repro_torch.service.scheduler import FairExecutor
from repro_torch.service.transcode import TranscodeManager

CHUNK = 32 << 10
SMALL = dict(max_workers=3, cache_budget_bytes=4 << 20, chunk_size=CHUNK)

KINDS = {
    "gzip": lambda d: gzip_compress(d, 6),
    "bgzf": lambda d: bgzf_compress(d, 6),
    "multistream": lambda d: multistream_gzip(d, 6, stream_size=64 << 10),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """kind -> (path of the archive, its decompressed bytes)."""
    rng = np.random.default_rng(0x5E7)
    root = tmp_path_factory.mktemp("torch_service")
    out = {}
    for kind, compress in KINDS.items():
        data = make_text(rng, 120_000) + make_base64(rng, 100_000)
        path = root / ("%s.gz" % kind)
        path.write_bytes(compress(data))
        out[kind] = (str(path), data)
    return out


@pytest.fixture
def no_shared_engine(monkeypatch):
    """Make the process-wide engine unreachable: any call fails the test."""
    calls = []

    def refuse(device="cuda"):
        calls.append(device)
        raise AssertionError("shared_engine(%r) reached" % device)

    monkeypatch.setattr(tengine, "shared_engine", refuse)
    return calls


def _picks(n, seed=3, count=8, size=9000):
    rng = np.random.default_rng(seed)
    return [(int(o), int(rng.integers(0, size))) for o in rng.integers(0, n, count)]


def _stat_fields(stat):
    return {k: v for k, v in stat.as_dict().items() if k != "handle"}


def _keys(tree, depth=2):
    """Nested key set of a snapshot down to ``depth`` levels."""
    if depth == 0 or not isinstance(tree, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_range_read_many_stat_and_index_blob_match_reference(corpus, kind):
    path, data = corpus[kind]
    picks = _picks(len(data))
    with ArchiveServer(device="cpu", **SMALL) as srv, ref_service.ArchiveServer(**SMALL) as ref:
        h, rh = srv.open(path, tenant="t"), ref.open(path, tenant="t")
        assert srv.read_range(h, 0, len(data)) == ref.read_range(rh, 0, len(data)) == data
        got = srv.read_many([(h, o, n) for o, n in picks])
        assert got == ref.read_many([(rh, o, n) for o, n in picks])
        assert got == [data[o : o + n] for o, n in picks]
        assert srv.read_range(h, len(data) + 10, 5) == ref.read_range(rh, len(data) + 10, 5) == b""
        assert srv.size(h) == ref.size(rh) == len(data)
        assert _stat_fields(srv.stat(h)) == _stat_fields(ref.stat(rh))
        key, blob = srv.index_blob(h)
        assert (key, blob) == ref.index_blob(rh)
        assert GzipIndex.from_bytes(blob).finalized


def test_persist_and_reopen_is_warm_in_both_packages(corpus, tmp_path):
    """The port persists into a store directory; a port server and a
    reference server over that directory both open warm, with no first
    pass, and serve the same bytes."""
    path, data = corpus["gzip"]
    store_dir = str(tmp_path / "idx")
    with ArchiveServer(device="cpu", index_store=IndexStore(store_dir), **SMALL) as srv:
        h = srv.open(path)
        assert srv.read_range(h, 1000, 5000) == data[1000:6000]
        assert srv.persist_index(h) is None  # first pass not finished yet
        assert srv.size(h) == len(data)
        key = srv.persist_index(h)
        assert key == srv.stat(h).identity
    picks = _picks(len(data), seed=11)
    for server in (
        ArchiveServer(device="cpu", index_store=IndexStore(store_dir), **SMALL),
        ref_service.ArchiveServer(index_store=ref_service.IndexStore(store_dir), **SMALL),
    ):
        with server:
            h = server.open(path)
            assert server.read_many([(h, o, n) for o, n in picks]) == [
                data[o : o + n] for o, n in picks
            ]
            assert server.stat(h).index_was_warm
            fetcher = server.metrics()["fleet"]["fetcher"]
            assert fetcher["nominal_tasks"] == 0 and fetcher["indexed_tasks"] > 0


def test_metrics_key_set_matches_reference(corpus):
    path, data = corpus["multistream"]
    snaps = []
    for server in (ArchiveServer(device="cpu", **SMALL), ref_service.ArchiveServer(**SMALL)):
        with server:
            h = server.open(path, tenant="a")
            assert server.read_range(h, 0, len(data)) == data
            snap = server.metrics()
            snap["obs"].pop("histograms")  # process-wide registries, per package
            snaps.append(snap)
    port, ref = snaps
    assert _keys(port) == _keys(ref)
    assert set(port["engine"]) == set(ref["engine"])
    assert port["engine"]["requests"]["crc"] > 0


def test_async_server_read_many_matches_reference(corpus):
    path, data = corpus["bgzf"]
    picks = _picks(len(data), seed=7, count=12)

    async def serve(server):
        async with server as srv:
            h = await srv.open(path, tenant="async")
            out = await srv.read_many([(h, o, n) for o, n in picks])
            stat = await srv.stat(h)
            return out, stat.decompressed_size

    port = asyncio.run(serve(AsyncArchiveServer(device="cpu", **SMALL)))
    ref = asyncio.run(serve(ref_service.AsyncArchiveServer(**SMALL)))
    assert port == ref
    assert port[0] == [data[o : o + n] for o, n in picks]


def _transcode_twin(server_cls, store_cls, src, text, **kw):
    with server_cls(
        index_store=store_cls(), max_workers=3, chunk_size=CHUNK,
        transcode_options={"min_input_bytes": 1, "span_bytes": 1 << 16}, **kw,
    ) as srv:
        h = srv.open(src)
        assert srv.read_range(h, 0, len(text)) == text
        identity = srv.stat(h).identity
        assert srv.transcoder.wait(identity, timeout=120) == "installed"
        twin = srv.index_store.resolve_twin(identity)
        h2 = srv.open(src)
        assert srv.read_range(h2, 0, len(text)) == text
        st = srv.stat(h2)
        assert (st.twin, st.codec, st.identity) == ("bgzf", "bgzf", identity)
        return twin.codec_tag, twin.index_blob, srv.metrics()["transcode"]["counters"]


def test_transcode_to_bgzf_twin_matches_reference(tmp_path, no_shared_engine):
    """A fixed-Huffman archive probes seek-hostile; both packages re-encode
    it as the same BGZF twin, and reopen through it. The port's transcoder
    reads through the server's engine, never the process-wide one."""
    text = make_text(np.random.default_rng(0x7E57), 150_000)
    path = tmp_path / "hostile.gz"
    path.write_bytes(fixed_only_compress(text))
    port = _transcode_twin(ArchiveServer, IndexStore, str(path), text, device="cpu")
    ref = _transcode_twin(ref_service.ArchiveServer, ref_service.IndexStore, str(path), text)
    assert port == ref
    assert port[2]["installed"] == 1
    assert no_shared_engine == []


# ---------------------------------------------------------------------------
# no fallback hides the device
# ---------------------------------------------------------------------------

def test_cuda_server_raises_without_a_card(monkeypatch, no_shared_engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ArchiveServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        ArchiveServer(device="cuda", max_workers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncArchiveServer(device="cuda")
    with pytest.raises(ValueError):
        ArchiveServer(device="cpu", device_engine="gpu-please")


@pytest.mark.parametrize("config", [
    {"device": "cpu"},
    {"device_engine": "off"},
    {"device_engine": False},
    {"device_engine": None, "device": "cuda"},
])
def test_every_reader_resolves_through_the_servers_engine(
    corpus, monkeypatch, no_shared_engine, config
):
    """``device="cpu"`` and the host configurations build one server-owned
    CPU engine; every reader's stage 2 goes through it, it is the engine in
    ``metrics()``, and it is shut down with the server. The process-wide
    engine is never reached, and ``"off"`` never needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = ArchiveServer(**config, **SMALL)
    engine = srv.device_engine
    assert isinstance(engine, TorchDecodeEngine) and engine.device.type == "cpu"
    with srv:
        handles = []
        for kind in ("bgzf", "gzip"):
            path, data = corpus[kind]
            h = srv.open(path, tenant=kind)
            assert srv.read_range(h, 0, len(data)) == data
            handles.append(h)
        for h in handles:
            reader = srv._entries[h].reader  # noqa: SLF001 - the wiring under test
            assert reader._fetcher.resolver is engine  # noqa: SLF001
        snap = srv.metrics()["engine"]
        assert snap["requests"] == engine.stats()["requests"]
        assert snap["requests"]["crc"] > 0 and snap["requests"]["replace"] > 0
        assert snap["batches"] > 0 and snap["errors"] == 0
    assert engine.stats()["closed"]
    assert no_shared_engine == []


def test_external_engine_is_used_and_left_running(corpus, no_shared_engine):
    path, data = corpus["gzip"]
    with TorchDecodeEngine(device="cpu") as engine:
        with ArchiveServer(device_engine=engine, **SMALL) as srv:
            h = srv.open(path)
            assert srv.read_range(h, 0, len(data)) == data
            assert srv.metrics()["engine"]["batches"] == engine.stats()["batches"] > 0
        assert not engine.stats()["closed"]
    assert no_shared_engine == []


def test_transcode_manager_alone_reaches_only_the_engine_it_is_told(tmp_path, monkeypatch):
    """Built without a resolver, the manager takes the process-wide engine
    of the device it was given, once, and hands it to both of its
    readers; given a resolver, it takes no engine of its own."""
    asked = []
    engine = TorchDecodeEngine(device="cpu")

    def shared(device="cuda"):
        asked.append(device)
        return engine

    monkeypatch.setattr(tengine, "shared_engine", shared)
    text = make_text(np.random.default_rng(5), 120_000)
    path = tmp_path / "hostile.gz"
    path.write_bytes(fixed_only_compress(text))
    key = file_identity(str(path))
    ex = FairExecutor(2)
    try:
        mgr = TranscodeManager(IndexStore(), ex, device="cpu", min_input_bytes=1,
                               span_bytes=1 << 16)
        assert asked == ["cpu"] and mgr.resolver is engine
        with ParallelGzipReader(str(path), chunk_size=CHUNK, parallelization=2,
                                resolver=engine) as r:
            assert r.read() == text
            assert mgr.consider(key, str(path), r)
        assert mgr.wait(key, timeout=120) == "installed"
        assert asked == ["cpu"]
        other = TranscodeManager(IndexStore(), ex, resolver=engine)
        assert other.resolver is engine and asked == ["cpu"]
    finally:
        ex.shutdown(wait=True)
        engine.shutdown()
