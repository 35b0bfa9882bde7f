"""repro_torch.core.ParallelGzipReader against the JAX package and zlib.

Every archive is built with ``repro.core.synth`` inside the test and read
through the port with its stage 2 on the CPU engine (``device="cpu"``, the
kernels' plain versions). Bytes, random reads and exported seek indexes must
be identical to ``repro.core.ParallelGzipReader`` and to zlib; a seek index
crosses between the two packages in both directions.
"""

import gzip
import io

import numpy as np
import pytest
import torch

from repro.core import GzipIndex as RefGzipIndex
from repro.core import ParallelGzipReader as RefReader
from repro.core.synth import COMPRESSORS
from repro_torch.core import GzipIndex, ParallelGzipReader
from repro_torch.core.errors import GzipFooterError
from repro_torch.kernels import engine as tengine

from conftest import make_base64, make_text

CHUNK = 48 << 10


def reader(comp, **kw):
    kw.setdefault("parallelization", 3)
    kw.setdefault("chunk_size", CHUNK)
    kw.setdefault("device", "cpu")
    return ParallelGzipReader(comp, **kw)


def data_for(request, n=300_000, kind=make_base64):
    return kind(np.random.default_rng(list(request.node.name.encode())), n)


def export_bytes(r) -> bytes:
    buf = io.BytesIO()
    r.export_index(buf)
    return buf.getvalue()


def test_roundtrip_codecs_match_reference(request, codec_case):
    data = data_for(request)
    comp = codec_case.compress(data)
    with reader(comp) as r:
        assert r.codec.tag == codec_case.tag
        got = r.read()
    with RefReader(comp, parallelization=3, chunk_size=CHUNK) as ref:
        assert got == ref.read() == data
    if codec_case.tag != "zstd":
        assert got == gzip.decompress(comp)


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_roundtrip_all_compressor_variants(request, name):
    data = data_for(request, 200_000, make_text)
    comp = COMPRESSORS[name](data)
    with reader(comp) as r:
        assert r.read() == gzip.decompress(comp) == data


def test_random_preads_match_reference(request, codec_case):
    data = data_for(request)
    comp = codec_case.compress(data)
    rng = np.random.default_rng(7)
    with reader(comp, parallelization=2) as r, RefReader(comp, chunk_size=CHUNK) as ref:
        for _ in range(24):
            off = int(rng.integers(0, len(data)))
            size = int(rng.integers(0, 40_000))
            got = r.pread(off, size)
            assert got == data[off : off + size] == ref.pread(off, size)
        assert r.pread(len(data) + 5, 10) == b""


def test_reference_index_drives_port(request, codec_case):
    """A blob exported by the reference imports into the port and serves
    every read with no speculative first pass."""
    data = data_for(request)
    comp = codec_case.compress(data)
    with RefReader(comp, parallelization=3, chunk_size=CHUNK) as ref:
        blob = export_bytes(ref)
    idx = GzipIndex.from_bytes(blob)
    assert idx.finalized and idx.decompressed_size == len(data)
    with reader(comp, index=idx) as r:
        assert r.read() == data
        r.seek(123_456)
        assert r.read(20_000) == data[123_456:143_456]
        assert r.stats()["fetcher"]["nominal_tasks"] == 0


def test_port_exports_reference_index_bytes(request, codec_case):
    """Same file, chunk size and spacing: the port writes the reference's
    RPGZIDX2 blob byte for byte, and the reference can serve from it."""
    data = data_for(request)
    comp = codec_case.compress(data)
    with reader(comp, index_spacing=64 << 10) as r:
        ours = export_bytes(r)
    with RefReader(comp, parallelization=3, chunk_size=CHUNK, index_spacing=64 << 10) as ref:
        assert export_bytes(ref) == ours
    with RefReader(comp, chunk_size=CHUNK, index=RefGzipIndex.from_bytes(ours)) as ref:
        assert ref.read() == data
        assert ref.stats()["fetcher"]["nominal_tasks"] == 0


def test_reference_index_file_imports(request, tmp_path):
    data = data_for(request)
    comp = gzip.compress(data, 6)
    path = str(tmp_path / "ref.rpgzidx")
    with RefReader(comp, chunk_size=CHUNK) as ref:
        ref.export_index(path)
    with reader(comp, index=path) as r:
        r.seek(250_000)
        assert r.read(30_000) == data[250_000:280_000]
        assert r.stats()["fetcher"]["nominal_tasks"] == 0
    assert GzipIndex.import_file(path).to_bytes() == RefGzipIndex.import_file(path).to_bytes()


def test_stage2_runs_on_the_engine(request):
    """The first pass hands marker resolution and CRC verification to the
    engine: it batches both and never falls back."""
    data = data_for(request)
    comp = gzip.compress(data, 6)
    with tengine.TorchDecodeEngine(device="cpu") as eng:
        with reader(comp, resolver=eng) as r:
            assert r.read() == data
        stats = eng.stats()
    assert stats["batches"] > 0 and stats["tiles_dispatched"] > 0
    assert stats["crc_bytes"] == len(data)
    assert stats["fallbacks"] == {"replace": 0, "crc": 0} and stats["errors"] == 0


def test_crc_mismatch_is_detected(request):
    data = data_for(request, 100_000)
    comp = bytearray(gzip.compress(data, 6))
    comp[-8] ^= 0xFF  # stored CRC32
    with reader(bytes(comp)) as r, pytest.raises(GzipFooterError):
        r.read()


def test_default_device_is_the_card(monkeypatch):
    """Without a resolver the reader takes the shared CUDA engine, and on a
    host without CUDA it refuses rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tengine, "_shared", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelGzipReader(gzip.compress(b"x" * 1000))


def test_http_source_waits_for_a_later_slice(request):
    """An http(s) source, which slice 1 refused, opens through the port's
    RemoteFileReader (core/remote.py) since slice 3, as in the reference."""
    from _range_server import RangeHTTPServer

    from repro_torch.core import RemoteFileReader

    data = data_for(request, 60_000)
    with RangeHTTPServer(gzip.compress(data, 6)) as srv, reader(srv.url) as r:
        assert isinstance(r._reader, RemoteFileReader)  # noqa: SLF001
        assert r.read() == data
