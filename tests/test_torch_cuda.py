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
from repro_torch.core.markers import replace_markers as cpu_replace
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import marker_replace as tmr
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


@pytest.mark.parametrize("n_tiles,n_tables", [(1, 1), (32, 8), (512, 1)])
def test_marker_kernel_matches_plain(cuda, rng, n_tiles, n_tables):
    """Symbols and table ids include out-of-range pad values."""
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


def test_marker_single_table_kernel(cuda, rng):
    table = tref.make_replacement_table(rng.integers(0, 256, 32768, dtype=np.uint8).tobytes())
    syms = torch.from_numpy(rng.integers(0, TABLE_SIZE, (4, 8, 1024), dtype=np.int64)
                            .astype(np.uint16))
    out = tmr.marker_replace_tiles(syms.to(cuda), table.to(cuda)).cpu()
    assert torch.equal(out, tmr.marker_replace_tiles(syms, table))


@pytest.mark.parametrize("batch,seg_len", [(1, 1), (1, 7), (8, 4096), (16, 64)])
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
    for i in (0, lanes.shape[0] - 1):
        assert int(got[i]) == zlib.crc32(lanes[i].tobytes())


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
