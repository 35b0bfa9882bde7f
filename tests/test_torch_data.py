"""repro_torch.data against the JAX package's gzip-corpus pipeline.

The port's ``GzipCorpusDataset`` (stage 2 on the kernels' plain versions,
``device="cpu"``) and the reference's read the same seeded shards; every
batch's ``tokens`` must be equal, exactly: local shards, ``http://`` shards
from the loopback range server, a ``gateway+http://`` shard of a port
gateway, shard subsets, and the continuation after a mid-shard restore. A
pipeline that shares an ``ArchiveServer``'s pool, executor and index store
passes ``resolver=server.device_engine``: that engine serves every reader,
and the process-wide ``shared_engine`` is never reached. ``device="cuda"``
on a host without a card raises.
"""

import gzip as _gzip

import numpy as np
import pytest
import torch

import repro.data as ref_data
import repro.service as ref_service
from _range_server import RangeHTTPServer
from conftest import gzip_bytes, make_text
from repro_torch.core import GzipIndex
from repro_torch.data import BOS, EOS, PAD, ByteTokenizer, GzipCorpusDataset, PipelineState
from repro_torch.kernels import engine as tengine
from repro_torch.service import ArchiveServer, CachePool, FairExecutor, IndexStore
from repro_torch.service.gateway import GatewayClient, GatewayServer

KW = dict(seq_len=64, batch_size=2, parallelization=2, chunk_size=32 << 10)


@pytest.fixture
def no_shared_engine(monkeypatch):
    """Make the process-wide engine unreachable: any call fails the test."""
    calls = []

    def refuse(device="cuda"):
        calls.append(device)
        raise AssertionError("shared_engine(%r) reached" % device)

    monkeypatch.setattr(tengine, "shared_engine", refuse)
    return calls


def _shards(seed, n_shards=2, size=120_000):
    rng = np.random.default_rng(seed)
    return [_gzip.compress(make_text(rng, size), 6) for _ in range(n_shards)]


def _batches(ds, n):
    out = []
    for _ in range(n):
        b = ds.next_batch()
        if b is None:
            break
        out.append(b["tokens"])
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _pair(shards, **kw):
    """(port dataset on the CPU, reference dataset) over the same shards."""
    return GzipCorpusDataset(shards, device="cpu", **kw), ref_data.GzipCorpusDataset(shards, **kw)


def test_tokenizer_matches_reference():
    rng = np.random.default_rng(7)
    data = make_text(rng, 5000) + bytes(range(256))
    tok, ref = ByteTokenizer(), ref_data.ByteTokenizer()
    assert (PAD, BOS, EOS) == (ref_data.PAD, ref_data.BOS, ref_data.EOS)
    for flags in ((True, True), (False, True), (True, False), (False, False)):
        got = tok.encode(data, add_bos=flags[0], add_eos=flags[1])
        np.testing.assert_array_equal(got, ref.encode(data, add_bos=flags[0], add_eos=flags[1]))
        assert tok.decode(got) == ref.decode(got) == data
    with pytest.raises(ValueError):
        ByteTokenizer(vocab_size=258)


def test_batch_shapes_and_determinism_match_reference():
    shards = _shards(11)
    kw = dict(KW, seq_len=128, batch_size=4, loop=True)
    port, ref = _pair(shards, **kw)
    again = GzipCorpusDataset(shards, device="cpu", **kw)
    got = _batches(port, 3)
    assert got[0].shape == (4, 129)
    _assert_same(got, _batches(ref, 3))
    _assert_same(_batches(again, 3), got)
    for ds in (port, ref, again):
        ds.close()


def test_tokens_reproduce_corpus_like_reference():
    shards = _shards(12, n_shards=1, size=50_000)
    truth = _gzip.decompress(shards[0])
    port, ref = _pair(shards, **dict(KW, parallelization=1, loop=False))
    got, want = _batches(port, 1000), _batches(ref, 1000)
    _assert_same(got, want)
    assert port.next_batch() is None
    port.close()
    ref.close()
    stream = np.concatenate([b.reshape(-1) for b in got])
    assert stream[0] == BOS
    decoded = ByteTokenizer().decode(stream)
    assert decoded == truth  # the EOS padding of the last batch decodes to nothing
    assert set(stream[1 + len(truth):].tolist()) <= {EOS}


@pytest.mark.parametrize("shard_id", [0, 1])
def test_sharded_pipelines_are_disjoint_and_match_reference(shard_id):
    shards = _shards(13, n_shards=4, size=30_000)
    kw = dict(KW, num_shards=2, loop=False)
    port, ref = _pair(shards, shard_id=shard_id, **kw)
    other = GzipCorpusDataset(shards, device="cpu", shard_id=1 - shard_id, **kw)
    got = _batches(port, 1000)
    _assert_same(got, _batches(ref, 1000))
    theirs = _batches(other, 1)
    assert not np.array_equal(got[0], theirs[0])
    mine = ByteTokenizer().decode(np.concatenate([b.reshape(-1) for b in got]))
    assert mine == b"".join(_gzip.decompress(s) for s in shards[shard_id::2])
    for ds in (port, ref, other):
        ds.close()
    with pytest.raises(ValueError):
        GzipCorpusDataset(shards[:1], device="cpu", shard_id=1, num_shards=2)


def test_checkpoint_resume_mid_shard_matches_reference():
    """State saved in the middle of a shard; a new dataset of either package
    that loads it continues with the batches the first run went on to give."""
    shards = _shards(14, n_shards=1, size=200_000)
    kw = dict(KW, seq_len=96, read_block=16 << 10, loop=True)
    port, ref = _pair(shards, **kw)
    _assert_same(_batches(port, 5), _batches(ref, 5))
    state, ref_state = port.state_dict(), ref.state_dict()
    assert state == ref_state
    assert 0 < state["byte_offset"] < 200_000 and state["pending_buffer"] > 0
    expected = _batches(port, 3)
    _assert_same(expected, _batches(ref, 3))
    port.close()
    ref.close()
    for restored in _pair(shards, **kw):
        restored.load_state_dict(state)
        _assert_same(_batches(restored, 3), expected)
        restored.close()
    assert PipelineState.from_dict(state).as_dict() == {
        k: state[k] for k in ("shard_idx", "byte_offset", "buffered_tokens")}


def test_index_reuse_makes_the_restore_indexed():
    shards = _shards(15, n_shards=1, size=150_000)
    kw = dict(seq_len=64, batch_size=2, loop=True)
    ds = GzipCorpusDataset(shards, device="cpu", **kw)
    _batches(ds, 3)
    idx_bytes = ds.export_indexes()
    st = ds.state_dict()
    expected = _batches(ds, 2)
    ds.close()
    assert 0 in idx_bytes
    indexes = {k: GzipIndex.from_bytes(v) for k, v in idx_bytes.items()}
    ds2 = GzipCorpusDataset(shards, device="cpu", indexes=indexes, **kw)
    ds2.load_state_dict(st)
    _assert_same(_batches(ds2, 2), expected)
    assert ds2._reader.stats()["fetcher"]["nominal_tasks"] == 0  # noqa: SLF001
    ds2.close()


def test_remote_shard_matches_local_and_reference(tmp_path):
    rng = np.random.default_rng(16)
    blob = gzip_bytes(make_text(rng, 200_000), 6)
    path = tmp_path / "shard-0.gz"
    path.write_bytes(blob)
    kw = dict(KW, read_block=16 << 10, loop=False)
    local = GzipCorpusDataset([str(path)], device="cpu", **kw)
    with RangeHTTPServer(blob) as srv:
        store = IndexStore()
        remote = GzipCorpusDataset([srv.url], device="cpu", index_store=store, **kw)
        ref = ref_data.GzipCorpusDataset([srv.url], index_store=ref_service.IndexStore(), **kw)
        got = _batches(remote, 4)
        _assert_same(got, _batches(local, 4))
        _assert_same(got, _batches(ref, 4))
        ref.close()
        heads = srv.head_requests
        remote.close()  # persists the shard's index under the ETag key
        local.close()
        assert srv.head_requests == heads  # the close-time put reuses the open key
        assert store.stats.puts == 1
        remote2 = GzipCorpusDataset([srv.url], device="cpu", index_store=store, **kw)
        _assert_same(_batches(remote2, 1), got[:1])
        remote2.close()
        assert store.stats.hits >= 1


def test_remote_shard_opens_with_one_head_request():
    rng = np.random.default_rng(17)
    blob = gzip_bytes(make_text(rng, 100_000), 6)
    with RangeHTTPServer(blob) as srv:
        ds = GzipCorpusDataset([srv.url], device="cpu", index_store=IndexStore(),
                               **dict(KW, read_block=16 << 10, loop=False))
        assert len(_batches(ds, 2)) == 2
        assert srv.head_requests == 1
        ds.close()
        assert srv.head_requests == 1


def test_gateway_shard_matches_reference(tmp_path):
    """A ``gateway+http://`` shard reads decompressed bytes from a port
    gateway: the same batches as the reference over the local file."""
    rng = np.random.default_rng(18)
    data = make_text(rng, 150_000)
    path = tmp_path / "gw-shard.gz"
    path.write_bytes(gzip_bytes(data, 6))
    kw = dict(KW, read_block=16 << 10, loop=False)
    with GatewayServer(device="cpu", cache_budget_bytes=4 << 20, max_workers=2,
                       chunk_size=32 << 10) as gw:
        client = GatewayClient(gw.url, source=str(path))
        try:
            shard = "gateway+" + gw.bytes_url(client.handle)
            for source in (shard, client):
                ds = GzipCorpusDataset([source], device="cpu", **kw)
                ref = ref_data.GzipCorpusDataset([str(path)], **kw)
                _assert_same(_batches(ds, 1000), _batches(ref, 1000))
                assert ds.export_indexes() == {}
                ds.close()
                ref.close()
            assert client.pread(0, 100) == data[:100]  # caller-owned client left open
        finally:
            client.close()


def test_pipeline_on_an_archive_servers_engine(tmp_path, no_shared_engine):
    """Shared pool, executor and index store of a port ``ArchiveServer``;
    stage 2 on that server's engine, never the process-wide one."""
    shards = _shards(19, n_shards=2, size=150_000)
    kw = dict(KW, loop=True)
    with ArchiveServer(device="cpu", max_workers=3, cache_budget_bytes=4 << 20,
                       chunk_size=32 << 10, index_store=IndexStore(str(tmp_path / "idx"))) as srv:
        engine = srv.device_engine
        before = sum(engine.stats()["requests"].values())

        def dataset(tenant):
            return GzipCorpusDataset(
                shards, device="cuda", resolver=engine, cache_pool=srv.cache_pool,
                executor=srv.executor, index_store=srv.index_store, tenant=tenant, **kw)

        ds = dataset("train")
        ref = ref_data.GzipCorpusDataset(shards, **kw)
        _assert_same(_batches(ds, 3), _batches(ref, 3))
        assert ds._reader._fetcher.resolver is engine  # noqa: SLF001
        assert sum(engine.stats()["requests"].values()) > before
        assert srv.executor.snapshot()["done"] > 0
        assert srv.cache_pool.snapshot()["tenants"]["train"]["insertions"] > 0
        while ds.state.shard_idx == 0:  # finishing shard 0 persists its index
            ref.next_batch()
            ds.next_batch()
        _assert_same(_batches(ds, 2), _batches(ref, 2))
        ds.close()
        ref.close()
        assert len(srv.index_store.keys()) >= 1

        warm = dataset("train-restart")
        warm.next_batch()
        st = warm._reader.stats()["fetcher"]  # noqa: SLF001
        assert st["nominal_tasks"] == 0 and st["exact_tasks"] == 0
        warm.close()
        stats = engine.stats()
        assert stats["errors"] == 0 and stats["fallbacks"] == {"replace": 0, "crc": 0}
    assert no_shared_engine == []


def test_shared_service_pool_without_a_server(tmp_path):
    """The reference's shared-pool test on the port's own CachePool,
    FairExecutor and IndexStore (stage 2 on the CPU engine)."""
    shards = _shards(20, n_shards=2, size=150_000)
    pool, executor = CachePool(4 << 20), FairExecutor(3)
    store = IndexStore(str(tmp_path / "indexes"))
    kw = dict(KW, loop=True)
    try:
        ds = GzipCorpusDataset(shards, device="cpu", cache_pool=pool, executor=executor,
                               index_store=store, tenant="train", **kw)
        ref = ref_data.GzipCorpusDataset(shards, **kw)
        _assert_same(_batches(ds, 3), _batches(ref, 3))
        assert executor.snapshot()["done"] > 0
        assert pool.snapshot()["tenants"]["train"]["insertions"] > 0
        while ds.state.shard_idx == 0:
            ds.next_batch()
        ds.close()
        ref.close()
        assert len(store.keys()) >= 1
    finally:
        executor.shutdown(wait=False)


def test_cuda_pipeline_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = GzipCorpusDataset(_shards(21, n_shards=1, size=20_000), **KW)
    assert ds.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.next_batch()
    ds.close()
