"""repro_torch.core.remote against the JAX package's, over one loopback server.

The port's ``RemoteFileReader`` and ``ParallelGzipReader(url, device="cpu")``
read from the same ``tests/_range_server.RangeHTTPServer`` as the
reference's: same bytes, same ``remote_identity`` (before and after the
object's validator changes), same seek index, and the port's own
``RemoteFileChangedError`` where the reference raises its own. No test here
sleeps: retries run with a no-op sleep.
"""

import io

import numpy as np
import pytest

import repro.core.remote as ref_remote
from _range_server import RangeHTTPServer
from conftest import make_base64, make_text
from repro.core import ParallelGzipReader as RefReader
from repro.core.errors import RemoteFileChangedError as RefChangedError
from repro.core.synth import bgzf_compress, gzip_compress, multistream_gzip
from repro.service.index_store import file_identity as ref_file_identity
from repro_torch.core import (
    NoPrefetch,
    ParallelGzipReader,
    RemoteFileReader,
    is_remote_url,
    open_file_reader,
    remote_identity,
)
from repro_torch.core.errors import RemoteFileChangedError, RemoteIOError
from repro_torch.service.index_store import file_identity

pytestmark = pytest.mark.remote

_NO_SLEEP = {"sleep": lambda _s: None}
CHUNK = 32 << 10

COMPRESS = {
    "gzip": lambda d: gzip_compress(d, 6),
    "bgzf": lambda d: bgzf_compress(d, 6),
    "multistream": lambda d: multistream_gzip(d, 6, stream_size=64 << 10),
}


def _pair(url, **kw):
    opts = dict(block_size=4096, cache_blocks=8, **_NO_SLEEP)
    opts.update(kw)
    return RemoteFileReader(url, **opts), ref_remote.RemoteFileReader(url, **opts)


def _export(r) -> bytes:
    buf = io.BytesIO()
    r.export_index(buf)
    return buf.getvalue()


@pytest.mark.parametrize("block_size", [4096, 16384])
def test_remote_reader_preads_match_reference(rng, block_size):
    data = make_base64(rng, 60_000)
    with RangeHTTPServer(data) as srv:
        port, ref = _pair(srv.url, block_size=block_size)
        with port, ref:
            assert port.size() == ref.size() == len(data)
            assert port.etag == ref.etag == srv.etag
            for off, n in ((0, 10), (4095, 2), (1000, 20_000), (59_990, 100), (70_000, 5)):
                assert port.pread(off, n) == ref.pread(off, n) == data[off : off + n]


def test_open_file_reader_dispatches_urls_to_the_remote_backend(rng):
    data = make_text(rng, 10_000)
    with RangeHTTPServer(data) as srv:
        assert is_remote_url(srv.url) and not is_remote_url("/tmp/x.gz")
        with open_file_reader(srv.url) as r:
            assert isinstance(r, RemoteFileReader)
            assert r.pread(0, 100) == data[:100]


def test_remote_identity_matches_reference(rng):
    data = make_base64(rng, 10_000)
    with RangeHTTPServer(data) as srv:
        before = remote_identity(srv.url, **_NO_SLEEP)
        assert before == ref_remote.remote_identity(srv.url, **_NO_SLEEP)
        assert file_identity(srv.url) == ref_file_identity(srv.url)
        srv.flip_etag('"rs-2"')
        after = remote_identity(srv.url, **_NO_SLEEP)
        assert after != before
        assert after == ref_remote.remote_identity(srv.url, **_NO_SLEEP)
        assert file_identity(srv.url) == ref_file_identity(srv.url)


def test_validator_change_raises_like_the_reference(rng):
    old, new = make_base64(rng, 60_000), make_base64(rng, 60_000)
    with RangeHTTPServer(old) as srv:
        port, ref = _pair(srv.url, cache_blocks=2)
        with port, ref:
            assert port.pread(0, 4096) == ref.pread(0, 4096) == old[:4096]
            srv.set_payload(new, '"rs-2"')
            with pytest.raises(RefChangedError):
                ref.pread(30_000, 4096)
            with pytest.raises(RemoteFileChangedError):
                port.pread(30_000, 4096)
            # Blocks cached at the open-time version stay consistent.
            assert port.pread(0, 4096) == old[:4096]


def test_retries_on_503_then_exhausts(rng):
    data = make_base64(rng, 20_000)
    with RangeHTTPServer(data) as srv:
        port, _ = _pair(srv.url, max_retries=2)
        with port:
            srv.faults.inject_503(2)
            assert port.pread(1000, 5000) == data[1000:6000]
            assert port.stats.retries >= 2
            srv.faults.inject_503(50)
            with pytest.raises(RemoteIOError):
                port.pread(12_000, 1000)


@pytest.mark.parametrize("kind", sorted(COMPRESS))
def test_parallel_reader_over_url_matches_reference(rng, kind):
    data = make_text(rng, 200_000)
    blob = COMPRESS[kind](data)
    with RangeHTTPServer(blob) as srv:
        with ParallelGzipReader(srv.url, parallelization=2, chunk_size=CHUNK,
                                device="cpu") as r:
            got = r.read()
            blob_port = _export(r)
            picks = [(int(o), 3000) for o in np.random.default_rng(5).integers(0, len(data), 6)]
            port_preads = [r.pread(o, n) for o, n in picks]
        with RefReader(srv.url, parallelization=2, chunk_size=CHUNK) as ref:
            assert got == ref.read() == data
            assert blob_port == _export(ref)
            assert port_preads == [ref.pread(o, n) for o, n in picks]


def test_parallel_reader_validator_change_mid_read_raises(rng):
    data = make_base64(rng, 240_000)
    with RangeHTTPServer(gzip_compress(data, 6)) as srv:
        r = ParallelGzipReader(
            RemoteFileReader(srv.url, block_size=16 << 10, cache_blocks=2, **_NO_SLEEP),
            parallelization=2,
            chunk_size=CHUNK,
            prefetch_strategy=NoPrefetch(),
            device="cpu",
        )
        with r:
            assert r.read(20_000) == data[:20_000]
            srv.set_payload(gzip_compress(data[::-1], 6), '"rs-2"')
            with pytest.raises(RemoteFileChangedError):
                while r.read(50_000):  # must raise, never return mixed bytes
                    pass
