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


@pytest.mark.parametrize("batch,seg_len", [
    (1, 1), (1, 7), (8, 4096), (16, 64),
    # either side of the split threshold (tcrc.SPLIT_MIN_SEG_LEN = 128)
    (1, 127), (1, 128), (16, 127), (16, 128),
    # the main path's 2048, ragged and unaligned lanes, and the seg_len of
    # ops.crc32_parallel over a 12.76 MB gzip
    (1, 2048), (16, 2048), (1, 1000), (16, 1000), (1, 4097), (16, 4097),
    (1, 12464), (16, 12464),
])
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
    syms = torch.zeros((1, 8, 1024), dtype=torch.uint16, device=cuda)
    tmr.marker_replace_tiles(syms, torch.zeros(TABLE_SIZE, dtype=torch.uint8, device=cuda))
    tcrc.crc32_segments(torch.zeros((8, 128, 16), dtype=torch.uint8, device=cuda),
                        tref.make_crc_table().to(cuda))
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
