"""repro_torch on the card: hand kernels against their plain versions, the
engine and the reader against the host path and zlib.

Every test here needs a CUDA device and nvcc, is marked ``cuda`` and skips
without them. The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import gzip
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import ParallelGzipReader
from repro_torch.core.block_finder import scan_dynamic_candidates
from repro_torch.core.markers import replace_markers as cpu_replace
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import marker_replace as tmr
from repro_torch.kernels import ops
from repro_torch.kernels import precode_check as tpc
from repro_torch.kernels import ref as tref
from repro_torch.kernels.engine import TorchDecodeEngine

pytestmark = pytest.mark.cuda

TABLE_SIZE = 256 + 32768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng(request):
    return np.random.default_rng(list(request.node.name.encode()))


@pytest.mark.parametrize("n_tiles,n_tables", [(1, 1), (8, 1), (8, 8), (16, 1), (16, 8), (32, 8),
                                              (200, 1), (200, 8), (512, 1), (1100, 8)])
def test_marker_kernel_matches_plain(cuda, rng, n_tiles, n_tables):
    """Symbols and table ids include out-of-range pad values. 512 and 1100
    tiles outgrow one wave of blocks, so each thread takes 4 steps."""
    tables = torch.from_numpy(rng.integers(0, 256, (n_tables, TABLE_SIZE), dtype=np.uint8)).to(cuda)
    syms = torch.from_numpy(
        rng.integers(0, 1 << 16, (n_tiles, 8, 1024), dtype=np.int64).astype(np.uint16)
    ).to(cuda)
    tids = torch.from_numpy(
        rng.integers(-1, n_tables + 1, n_tiles, dtype=np.int64).astype(np.int32)
    ).to(cuda)
    before = tmr.launches
    out = tmr.marker_replace_tiles_multi(syms, tables, tids)
    torch.cuda.synchronize()
    assert tmr.launches == before + 1
    assert torch.equal(out, tmr.marker_replace_tiles_multi_plain(syms, tables, tids))


@pytest.mark.parametrize("n_tiles", [4, 8, 16, 200])
def test_marker_single_table_kernel(cuda, rng, n_tiles):
    """The single-table form launches without tile ids; pad symbols give 0."""
    table = tref.make_replacement_table(rng.integers(0, 256, 32768, dtype=np.uint8).tobytes())
    syms = torch.from_numpy(rng.integers(0, 1 << 16, (n_tiles, 8, 1024), dtype=np.int64)
                            .astype(np.uint16))
    out = tmr.marker_replace_tiles(syms.to(cuda), table.to(cuda)).cpu()
    assert torch.equal(out, tmr.marker_replace_tiles(syms, table))


CRC_GRID = [
    (1, 1), (1, 7), (8, 4096), (16, 64),
    # either side of the split threshold (tcrc.SPLIT_MIN_SEG_LEN = 128)
    (1, 127), (1, 128), (16, 127), (16, 128),
    # the main path's 2048, ragged and unaligned lanes, and the seg_len of
    # ops.crc32_parallel over a 12.76 MB gzip
    (1, 2048), (16, 2048), (1, 1000), (16, 1000), (1, 4097), (16, 4097),
    (1, 12464), (16, 12464),
]


@pytest.mark.parametrize("batch,seg_len", CRC_GRID)
def test_crc_kernel_matches_plain_and_zlib(cuda, rng, batch, seg_len):
    host = rng.integers(0, 256, (batch, 8, 128, seg_len), dtype=np.uint8)
    data = torch.from_numpy(host).to(cuda)
    table = tref.make_crc_table().to(cuda)
    before = tcrc.launches
    out = tcrc.crc32_segments_batched(data, table)
    torch.cuda.synchronize()
    assert tcrc.launches == before + 1
    assert torch.equal(out, tcrc.crc32_segments_batched_plain(data, table))
    lanes = host.reshape(-1, seg_len)
    got = out.cpu().numpy().reshape(-1).astype(np.uint32)
    assert got.tolist() == [zlib.crc32(lane.tobytes()) for lane in lanes]


@pytest.mark.parametrize("batch,seg_len", CRC_GRID)
def test_crc_fold_kernel_matches_plain_and_zlib(cuda, rng, batch, seg_len):
    """The folding launch: each request's word is the plain fold's and
    zlib's CRC of its first ``full`` lanes (lanes past it hold random
    bytes), rows past ``full`` fold to 0, and the per-lane output is the
    non-folding launch's, bit for bit."""
    host = rng.integers(0, 256, (batch, 8, 128, seg_len), dtype=np.uint8)
    data = torch.from_numpy(host).to(cuda)
    table = tref.make_crc_table().to(cuda)
    full = [(0, 1, 2, 683, 1024, 1023, 512, 341)[i % 8] for i in range(max(1, batch - 1))]
    if batch == 1:
        full = [int(rng.integers(1, 1025))]
    before, fold_before, folds = tcrc.launches, tcrc.fold_launches, tcrc.folded_requests
    lanes, folded = tcrc.crc32_fold_batched(data, table, full)
    torch.cuda.synchronize()
    assert tcrc.launches == before + 1 and tcrc.fold_launches == fold_before + 1
    assert tcrc.folded_requests == folds + len(full)
    assert torch.equal(lanes, tcrc.crc32_segments_batched(data, table))
    assert tcrc.launches == before + 2 and tcrc.fold_launches == fold_before + 1
    plain_lanes, plain_folded = tcrc.crc32_fold_batched_plain(data, table, full)
    assert torch.equal(lanes, plain_lanes) and torch.equal(folded, plain_folded)
    want = [zlib.crc32(host[b].reshape(-1)[: f * seg_len].tobytes()) for b, f in enumerate(full)]
    want += [0] * (batch - len(full))
    assert folded.cpu().numpy().astype(np.uint32).tolist() == want


def test_crc_fold_kernel_slices_a_large_batch(cuda, rng):
    """More rows than one launch's parameters hold: one launch a slice."""
    batch = tcrc.MAX_FOLD_BATCH + 3
    host = rng.integers(0, 256, (batch, 8, 128, 16), dtype=np.uint8)
    full = rng.integers(0, 1025, batch).tolist()
    before, fold_before = tcrc.launches, tcrc.fold_launches
    _, folded = tcrc.crc32_fold_batched(torch.from_numpy(host).to(cuda),
                                        tref.make_crc_table().to(cuda), full)
    assert tcrc.launches == before + 2 and tcrc.fold_launches == fold_before + 2
    want = [zlib.crc32(host[b].reshape(-1)[: f * 16].tobytes()) for b, f in enumerate(full)]
    assert folded.cpu().numpy().astype(np.uint32).tolist() == want


#: About the decompressed bytes of the read cell's chunks (1 MiB of gzip -6
#: of base64 gives about 1.4 MB), a shorter last chunk, a request of 683
#: whole lanes of 2 KiB and one byte more, 1 MiB and 4 MiB.
READ_CHUNK_SIZES = (1_398_101, 1_416_342, 683 * 2048, 683 * 2048 + 1, 1 << 20, 301_777, 4 << 20)


def test_engine_fold_matches_zlib_at_read_chunk_sizes(cuda, rng):
    tcrc.reset_launches()
    with TorchDecodeEngine() as eng:
        for n in READ_CHUNK_SIZES:
            blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert eng.crc32(blob) == zlib.crc32(blob), n
        # Three at once: one batch of three requests.
        blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in READ_CHUNK_SIZES[:3]]
        futs = [eng.submit_crc(b) for b in blobs]
        assert [f.result(timeout=60) for f in futs] == [zlib.crc32(b) for b in blobs]
        assert eng.stats()["errors"] == 0
    assert tcrc.folded_requests == len(READ_CHUNK_SIZES) + 3
    assert tcrc.launches == tcrc.fold_launches >= 1


def test_crc_unbatched_kernel(cuda, rng):
    data = torch.from_numpy(rng.integers(0, 256, (8, 128, 100), dtype=np.uint8))
    table = tref.make_crc_table()
    assert torch.equal(tcrc.crc32_segments(data.to(cuda), table.to(cuda)).cpu(),
                       tcrc.crc32_segments(data, table))


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(tmr, "marker_replace_tiles_multi_plain", refuse)
    monkeypatch.setattr(tcrc, "crc32_segments_batched_plain", refuse)
    monkeypatch.setattr(tcrc, "crc32_fold_batched_plain", refuse)
    syms = torch.zeros((1, 8, 1024), dtype=torch.uint16, device=cuda)
    tmr.marker_replace_tiles(syms, torch.zeros(TABLE_SIZE, dtype=torch.uint8, device=cuda))
    tcrc.crc32_segments(torch.zeros((8, 128, 16), dtype=torch.uint8, device=cuda),
                        tref.make_crc_table().to(cuda))
    tcrc.crc32_fold_batched(torch.zeros((1, 8, 128, 16), dtype=torch.uint8, device=cuda),
                            tref.make_crc_table().to(cuda), [3])
    torch.cuda.synchronize()


def test_engine_matches_host_path(cuda, rng):
    tmr.reset_launches()
    tcrc.reset_launches()
    with TorchDecodeEngine(max_delay_s=0.005, max_batch_tiles=4) as eng:
        for n in (1, 8193, 9 * 8192 + 3):
            syms = rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)
            window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
            np.testing.assert_array_equal(eng.replace_markers(syms, window), cpu_replace(syms, window))
        for n in (1, 1024, 50_000, 3 << 20):
            blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert eng.crc32(blob) == zlib.crc32(blob)
        stats = eng.stats()
        assert stats["errors"] == 0 and not stats["interpret"]
        assert stats["fallbacks"] == {"replace": 0, "crc": 0}
    assert tmr.launches >= 5 and tcrc.launches >= 4


@pytest.mark.parametrize("kind", ["replace", "crc"])
def test_engine_routes_by_size_on_the_card(cuda, rng, kind):
    """A crossover dict on the card: below it the host path (a fallback, no
    launch), at or above it the kernel; both exact."""
    threshold = 3 * 8192 + 5
    tmr.reset_launches()
    tcrc.reset_launches()
    with TorchDecodeEngine(crossover={kind: threshold}, max_delay_s=0.005) as eng:
        assert not eng.force_device
        for n, on_card in ((threshold - 1, False), (threshold, True), (threshold + 40_000, True)):
            before = (tmr.launches, tcrc.launches)
            if kind == "replace":
                syms = rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)
                window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
                np.testing.assert_array_equal(eng.replace_markers(syms, window),
                                              cpu_replace(syms, window))
                launched = tmr.launches > before[0]
            else:
                blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                assert eng.crc32(blob) == zlib.crc32(blob)
                launched = tcrc.launches > before[1]
            assert launched == on_card, n
        stats = eng.stats()
        assert stats["fallbacks"][kind] == 1 and stats["requests"][kind] == 3
        assert stats["errors"] == 0
        other = "crc" if kind == "replace" else "replace"
        assert stats["requests"][other] == 0


def test_engine_auto_reads_the_committed_sweep(cuda):
    """crossover="auto" on the card is derive_crossover over the committed
    sweep's rows."""
    import json
    from pathlib import Path

    from repro_torch.kernels.engine import SWEEP_ARTIFACT, derive_crossover

    rows = json.loads((Path(__file__).resolve().parents[1] / SWEEP_ARTIFACT).read_text())["results"]
    with TorchDecodeEngine(crossover="auto") as eng:
        assert eng.crossover == derive_crossover(rows)


def test_reader_on_the_default_engine(cuda, rng):
    import base64

    data = base64.encodebytes(rng.integers(0, 256, 600_000, dtype=np.uint8).tobytes())
    comp = gzip.compress(data, 6)
    tmr.reset_launches()
    tcrc.reset_launches()
    with ParallelGzipReader(comp, chunk_size=64 << 10, parallelization=4) as r:
        assert r.read() == data
        for off in (0, 123_457, len(data) - 10):
            assert r.pread(off, 5000) == data[off : off + 5000]
    assert tmr.launches > 0 and tcrc.launches > 0


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "buffer_end"])
@pytest.mark.parametrize("start_bit,n", [(0, 1), (3, 2047), (13, 2049), (0, 5000), (5, 1 << 20)])
def test_precode_kernel_matches_plain(cuda, rng, start_bit, n, tight):
    """With ``tight`` the buffer ends at the last offset, so the last windows
    read past it (as zeros)."""
    nbytes = -(-(start_bit + n) // 8) + (0 if tight else 16)
    data = torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8)).to(cuda)
    before = tpc.launches
    out = tpc.precode_check_packed(data, start_bit, n)
    torch.cuda.synchronize()
    assert tpc.launches == before + 1
    assert torch.equal(out, tpc.precode_check_packed_plain(data, start_bit, n))


#: Streams at the extremes of the offsets passing steps 1-3: none (zeros,
#: ones), every third ((0, 0, 1) repeated) and a valid 29-bit header
#: repeated (final 0, type (0, 1), HLIT = HDIST = HCLEN = 0, four precode
#: lengths of 2).
STREAMS = {"zeros": [0], "ones": [1], "001": [0, 0, 1],
           "header29": [0, 0, 1] + [0] * 14 + [0, 1, 0] * 4}


def precode_size(size: str) -> int:
    """An odd offset count on either side of the kernel's switch to four
    words a lane (two such blocks of 32768 offsets per SM)."""
    if size == "small":
        return 100_003
    return 2 * torch.cuda.get_device_properties(0).multi_processor_count * 32768 + 1013


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("view", [False, True], ids=["aligned", "odd_address"])
@pytest.mark.parametrize("kind", list(STREAMS))
def test_precode_kernel_extreme_streams(cuda, kind, view, size):
    """Across many blocks, at an unaligned start, with a buffer that ends at
    the last offset; ``odd_address`` passes a view one byte into its
    allocation, so the staging loads start at a misaligned address."""
    start_bit, n = 13, precode_size(size)
    nbits = start_bit + n
    bits = np.resize(np.array(STREAMS[kind], np.uint8), 8 * -(-nbits // 8) + 8 * view)
    data = torch.from_numpy(np.packbits(bits, bitorder="little")).to(cuda)
    if view:
        data = data[1:]
    out = tpc.precode_check_packed(data, start_bit, n)
    plain = tpc.precode_check_packed_plain(data, start_bit, n)
    assert torch.equal(out, plain)
    if kind == "header29":
        assert int(out.sum()) >= n // 29 - 3


@pytest.mark.parametrize("size", ["small", "large"])
def test_precode_kernel_8_byte_aligned_out(cuda, rng, size):
    """The C entry takes an output that is 8- but not 16-byte aligned."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.entry("precode_check", "precode_check_launch",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p])
    n = precode_size(size)
    data = torch.from_numpy(rng.integers(0, 256, n // 8 + 16, dtype=np.uint8)).to(cuda)
    buf = torch.full((n + 8,), 7, dtype=torch.uint8, device=cuda)
    rc = fn(data.data_ptr(), data.numel(), 3, n, buf[8:].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    assert torch.equal(buf[8:], tpc.precode_check_packed_plain(data, 3, n))
    assert bool((buf[:8] == 7).all())


def test_precode_blocks_kernel(cuda, rng):
    planes = torch.from_numpy(rng.integers(0, 2, (5, tpc.BLOCK), dtype=np.uint8))
    planes[-1] = 0
    assert torch.equal(tpc.precode_check_blocks(planes.to(cuda)).cpu(),
                       tpc.precode_check_blocks(planes))


def test_ops_on_the_card_match_host_path(cuda, rng):
    tpc.reset_launches()
    for nbytes, start, end in ((1000, 0, None), (40_000, 13, 200_001), (1 << 20, 0, None)):
        blob = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
        got = ops.precode_candidates(blob, start, end)
        np.testing.assert_array_equal(got, ops.precode_candidates(blob, start, end, device="cpu"))
        stop = nbytes * 8 - tpc.HALO if end is None else end
        host = [c for c in scan_dynamic_candidates(blob, start, nbytes * 8, full_validation=False)
                if c < stop]
        assert got.tolist() == host
    assert tpc.launches == 3
    comp = gzip.compress(base64_text(rng, 200_000), 6)
    assert ops.precode_candidates(comp).size > 0
    window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    for n in (0, 1, 8209, 100_000):
        syms = rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)
        np.testing.assert_array_equal(ops.marker_replace(syms, window), cpu_replace(syms, window))
        np.testing.assert_array_equal(ops.marker_replace(syms, None), cpu_replace(syms, None))
    for n in (0, 1, 1023, 4096, 100_001):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ops.crc32_parallel(blob) == zlib.crc32(blob)


def test_precode_cuda_never_takes_the_plain_version(cuda, rng, monkeypatch):
    def refuse(*args):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(tpc, "precode_check_packed_plain", refuse)
    monkeypatch.setattr(tmr, "marker_replace_tiles_multi_plain", refuse)
    monkeypatch.setattr(tcrc, "crc32_segments_batched_plain", refuse)
    before = tpc.launches
    ops.precode_candidates(rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    tpc.precode_check_blocks(torch.zeros((2, tpc.BLOCK), dtype=torch.uint8, device=cuda))
    ops.marker_replace(np.zeros(100, np.uint16), None)
    ops.crc32_parallel(b"abc" * 1000)
    torch.cuda.synchronize()
    assert tpc.launches == before + 2


def base64_text(rng, n):
    import base64

    return base64.encodebytes(rng.integers(0, 256, n * 3 // 4, dtype=np.uint8).tobytes())[:n]


@pytest.mark.parametrize("kind", ["gzip", "bgzf_and_gzip"])
def test_archive_server_on_the_card_matches_cpu_server(cuda, rng, monkeypatch, kind):
    """An ArchiveServer on the card serves the same bytes as one on the CPU;
    its own engine launched both kernels, with no fallback, and the
    process-wide engine was never reached."""
    from repro_torch.kernels import engine as tengine
    from repro_torch.service import ArchiveServer

    def refuse(device="cuda"):
        raise AssertionError("shared_engine(%r) reached" % device)

    monkeypatch.setattr(tengine, "shared_engine", refuse)
    data = base64_text(rng, 400_000)
    blobs = [gzip.compress(data, 6)]
    if kind == "bgzf_and_gzip":
        from repro_torch.core.synth import bgzf_compress

        blobs.append(bgzf_compress(data, 6))
    picks = [(int(o), int(n)) for o, n in zip(rng.integers(0, len(data), 16),
                                             rng.integers(1, 50_000, 16))]
    opts = dict(max_workers=4, chunk_size=64 << 10, cache_budget_bytes=8 << 20)
    served = []
    tmr.reset_launches()
    tcrc.reset_launches()
    for device in ("cuda", "cpu"):
        with ArchiveServer(device=device, **opts) as srv:
            out = []
            for i, blob in enumerate(blobs):
                h = srv.open(blob, tenant="t%d" % i)
                out.append(srv.read_range(h, 0, len(data)))
                out.extend(srv.read_many([(h, o, n) for o, n in picks]))
            assert srv.device_engine.device.type == device
            stats = srv.metrics()["engine"]
            assert stats["interpret"] is (device == "cpu")
            assert stats["errors"] == 0 and stats["fallbacks"] == {"replace": 0, "crc": 0}
            assert stats["requests"]["replace"] > 0 and stats["requests"]["crc"] > 0
        served.append(out)
        if device == "cuda":
            assert tmr.launches > 0 and tcrc.launches > 0
    assert served[0] == served[1]
    assert served[0][0] == data


def test_fleet_pread_failover_on_the_card(cuda, rng, monkeypatch, tmp_path):
    """Two gateway peers, each over its own ArchiveServer and engine on the
    card. Killing the owner under a held connection returns at once and
    shuts its engine down; the next pread fails over to the other peer and
    returns the same bytes."""
    import time

    from repro_torch.kernels import engine as tengine
    from repro_torch.service.fleet import FleetRouter
    from repro_torch.service.gateway import GatewayServer

    def refuse(device="cuda"):
        raise AssertionError("shared_engine(%r) reached" % device)

    monkeypatch.setattr(tengine, "shared_engine", refuse)
    data = base64_text(rng, 600_000)
    path = tmp_path / "fleet.gz"
    path.write_bytes(gzip.compress(data, 6))
    opts = dict(max_workers=4, chunk_size=64 << 10, cache_budget_bytes=8 << 20)
    gws = [GatewayServer(device="cuda", stream_span=64 << 10, **opts).start() for _ in range(2)]
    router = FleetRouter([gw.url for gw in gws], eject_after=1)
    try:
        c = router.open(str(path), block_size=16 << 10, cache_blocks=1)
        owner = next(gw for gw in gws if gw.url == c.peer)
        engine = owner.server.device_engine
        assert engine.device.type == "cuda"
        assert c.pread(0, len(data)) == data
        t0 = time.monotonic()
        owner.close()
        assert time.monotonic() - t0 < 1.0
        assert engine.stats()["closed"]
        tmr.reset_launches()
        tcrc.reset_launches()
        assert c.pread(400_000, 50_000) == data[400_000:450_000]
        assert c.stats["failovers"] == 1 and c.peer != owner.url
        survivor = next(gw for gw in gws if gw.url == c.peer)
        stats = survivor.server.device_engine.stats()
        assert stats["errors"] == 0 and stats["fallbacks"] == {"replace": 0, "crc": 0}
        assert tmr.launches > 0 and tcrc.launches > 0  # the survivor's first pass
        c.close()
    finally:
        router.close()
        for gw in gws:
            gw.close()


def test_one_shard_pipeline_on_the_card_matches_cpu(cuda, rng):
    """GzipCorpusDataset on the card's engine gives the batches of one on
    the kernels' plain versions, and launched both kernels."""
    from repro_torch.data import GzipCorpusDataset

    shard = gzip.compress(base64_text(rng, 500_000), 6)
    kw = dict(seq_len=256, batch_size=4, parallelization=4, chunk_size=64 << 10, loop=False)
    tmr.reset_launches()
    tcrc.reset_launches()
    got = {}
    for device in ("cuda", "cpu"):
        ds = GzipCorpusDataset([shard], device=device, **kw)
        got[device] = [b["tokens"] for b in ds]
        ds.close()
        if device == "cuda":
            assert tmr.launches > 0 and tcrc.launches > 0
    assert len(got["cuda"]) == len(got["cpu"]) > 0
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the model half: decoders on the card against the same module on the host
# ---------------------------------------------------------------------------

def _card_and_host(arch, cuda):
    from repro_torch.configs import all_configs, smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(all_configs()[arch])
    card = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    return cfg, card, host


def _serve(model, tokens, prompt):
    """Forward logits, then prefill plus decode of the remaining tokens."""
    from repro_torch.models import transformer
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    B, S = tokens.shape
    with torch.inference_mode():
        full = transformer.forward(model.cfg, model, tokens, mode="train")[0]
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=S)
    logits, pc = prefill_fn({"tokens": tokens[:, :prompt]})
    caches = prefill_to_decode_caches(model.cfg, model, pc, B, S, prompt)
    steps = [logits[:, 0]]
    for t in range(prompt, S):
        _, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t)
        steps.append(logits_d[:, 0])
    return full, torch.stack(steps, dim=1)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_decoder_on_the_card_matches_the_host(cuda, arch):
    """A dense and a MoE config at smoke width: the card's forward and
    serve-step logits against the same weights on the host (which the CPU
    tests hold to the JAX package), and decode against the forward, all at
    rtol = atol = 5e-2 (cuBLAS and the host's bf16 products sum in other
    orders)."""
    cfg, card, host = _card_and_host(arch, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 30), generator=torch.Generator().manual_seed(1))
    full_c, served_c = _serve(card, tokens.to(cuda), 24)
    full_h, served_h = _serve(host, tokens, 24)
    assert full_c.device.type == "cuda" and served_c.device.type == "cuda"
    torch.testing.assert_close(full_c.float().cpu(), full_h.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(served_c.float().cpu(), served_h.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(served_c.float(), full_c[:, 23:].float(), rtol=5e-2, atol=5e-2)


def test_build_model_allocates_on_the_card_by_default(cuda):
    from repro_torch.configs import all_configs, smoke_config
    from repro_torch.models import build_model

    model = build_model(smoke_config(all_configs()["hymba-1.5b"]))
    assert model.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in model.parameters())
    caches = model.init_decode_caches(2, 96)
    assert caches["layers"]["attn"]["pos"].device.type == "cuda"
    assert caches["layers"]["ssm"]["h"].device.type == "cuda"


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny"])
def test_new_family_on_the_card_matches_the_host(cuda, arch):
    """The xLSTM and Whisper families at smoke width: the card's prefill
    and decode logits against the same weights on the host in fp64
    (1e-9; bf16 sums in other orders on either side, so the families are
    held where the arithmetic is exact to the last bits)."""
    import dataclasses

    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    cfg, card, host = _card_and_host(arch, cuda)
    cfg = dataclasses.replace(cfg, dtype=torch.float64)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    frames = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=gen, dtype=torch.float64)
    outs = []
    for model, dev in ((card, cuda), (host, torch.device("cpu"))):
        model.to(torch.float64)
        model.cfg = cfg
        extra = {"frames": frames.to(dev)} if cfg.family == "audio" else {}
        prefill_fn, decode_fn, _ = make_serve_steps(model, batch=2, max_len=20)
        logits, pc = prefill_fn({"tokens": tokens[:, :16].to(dev), **extra})
        caches = prefill_to_decode_caches(cfg, model, pc, 2, 20, 16)
        steps = [logits[:, 0]]
        for t in range(16, 19):
            _, logits_d, caches = decode_fn(tokens[:, t : t + 1].to(dev), caches, t)
            steps.append(logits_d[:, 0])
        outs.append(torch.stack(steps, 1))
    assert outs[0].device.type == "cuda"
    torch.testing.assert_close(outs[0].cpu(), outs[1], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-350m"])
def test_train_step_on_the_card_matches_the_host(cuda, arch):
    """Two train steps in fp64 from the same weights and batch on the card
    and on the host: loss and gradient norm within 1e-6 and every
    parameter within 1e-5 (the cross entropy and AdamW's moments are fp32
    in both packages, so the two devices' fp32 sums show: the loss 9.3e-8
    apart), gradients and moments on the card."""
    import dataclasses

    from repro_torch.models.layers import members, tree_leaves
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    cfg, card, host = _card_and_host(arch, cuda)
    cfg = dataclasses.replace(cfg, dtype=torch.float64)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 33),
                                     generator=torch.Generator().manual_seed(3)).int()}
    results = []
    for model in (card, host):
        model.to(torch.float64)
        model.cfg = cfg
        params = model.param_tree()
        opt = init_opt_state(params)
        step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
        metrics = []
        for _ in range(2):
            params, opt, m = step(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        devices = {t.device.type for leaf in tree_leaves(opt["m"]) for t in members(leaf)}
        results.append((metrics, step.grad_devices, devices))
    assert results[0][1] == results[0][2] == {"cuda"}
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for (name, a), b in zip(card.state_dict().items(), host.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5, msg=name)


# ---------------------------------------------------------------------------
# the mesh on the card: NCCL at world size 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_nccl_mesh_step_matches_the_one_card_step(cuda, arch):
    """The train step on make_host_mesh() (NCCL, (data, model) = (1, 1))
    against the one-card step from the same weights and batches: at world
    size 1 every collective is skipped and the arithmetic per element is the
    same, so losses, gradient norms and parameters are equal bit for bit;
    moments on the card, the group NCCL."""
    import torch.distributed as dist

    from repro_torch.configs import all_configs, smoke_config
    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = smoke_config(all_configs()[arch])
    mesh = make_host_mesh(device="cuda")
    assert dist.get_backend() == "nccl"
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 33), dtype=np.int32)}
               for _ in range(3)]
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for on_mesh in (False, True):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(6)
        model = build_model(cfg, device="cuda")
        params, opt = init_train_state(model, gen, compress_grads=True)
        step = make_train_step(model, mesh, default_rules(mesh), ocfg, compress_grads=True)[0] \
            if on_mesh else make_train_step(model, ocfg, compress_grads=True)
        metrics = []
        for batch in batches:
            params, opt, m = step(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [t.clone() for t in tree_tensors(params)],
                     {t.device.type for t in tree_tensors(opt["m"])}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[1][2] == {"cuda"}


def test_compressed_psum_on_nccl(cuda):
    """compressed_psum over the NCCL group of one rank: the int8 round trip
    of compress/decompress, bit for bit."""
    from repro_torch.distributed import compress, compressed_psum, decompress
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cuda")
    x = torch.randn((257, 129), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda") * 3
    q, scale = compress(x)
    got = compressed_psum(x, "data", mesh=mesh)
    assert got.device.type == "cuda" and got.dtype == x.dtype
    assert torch.equal(got, decompress(q, scale))
    bf = compressed_psum(x.to(torch.bfloat16), "data", mesh=mesh)
    assert bf.dtype == torch.bfloat16


def test_nccl_mesh_serve_matches_one_card(cuda):
    """make_serve_steps(model, mesh, rules, ...) at world size 1 against the
    one-card serve steps: the same greedy tokens and logits, caches on the
    card in the shape caches_abstract gives."""
    from repro_torch.configs import all_configs, smoke_config
    from repro_torch.distributed import default_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    cfg = smoke_config(all_configs()["granite-3-2b"])
    mesh = make_host_mesh(device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator()
                            .manual_seed(2)).cuda()
    runs = []
    for on_mesh in (False, True):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(8)
        model = build_model(cfg, device="cuda").init(gen)
        if on_mesh:
            pre, dec, abstract, _ = make_serve_steps(model, mesh, default_rules(mesh), batch=4,
                                                     max_len=24)
            params = model.param_tree()
            prefill, decode = (lambda b: pre(params, b)), (lambda *a: dec(params, *a))
        else:
            prefill, decode, abstract = make_serve_steps(model, batch=4, max_len=24)
        logits, pc = prefill({"tokens": prompts})
        caches = prefill_to_decode_caches(cfg, model, pc, 4, 24, 16)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [logits]
        for t in range(8):
            tok, lg, caches = decode(tok, caches, 16 + t)
            out.append(lg)
        assert all(c.device.type == "cuda" for c in tree_leaves(caches))
        assert [tuple(a.shape) for a in tree_leaves(abstract)] == \
            [tuple(c.shape) for c in tree_leaves(caches)]
        runs.append(torch.cat([o[:, -1:] for o in out], 1))
    assert torch.equal(runs[0], runs[1])
