import gzip as _gzip
import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Optional hypothesis: property tests require it, but the bare container does
# not ship it (see requirements-test.txt). Install a minimal stub so the test
# modules still *collect*; @given-decorated tests are skipped at runtime.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:

    class _AnyStrategy:
        """Catch-all stand-in for hypothesis strategy objects."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    def _stub_given(*_args, **_kwargs):
        def decorate(fn):
            def skipper():
                pytest.skip("hypothesis is not installed (see requirements-test.txt)")

            # No functools.wraps: pytest follows __wrapped__ for signatures
            # and would then demand fixtures named after the strategies.
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            skipper.__module__ = fn.__module__
            return skipper

        return decorate

    def _stub_settings(*_args, **_kwargs):
        def decorate(fn):
            return fn

        return decorate

    _stub = types.ModuleType("hypothesis")
    _stub.given = _stub_given
    _stub.settings = _stub_settings
    _stub.assume = lambda *a, **k: True
    _stub.example = _stub_settings
    _stub.HealthCheck = types.SimpleNamespace(
        too_slow=None, data_too_large=None, filter_too_much=None
    )
    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.__getattr__ = lambda name: _AnyStrategy()
    _stub.strategies = _strategies
    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _strategies


def pytest_configure(config):
    # "remote" tests are network-free: they talk only to an in-process
    # loopback HTTP server (tests/_range_server.py), so tier-1 stays
    # offline-safe. The marker exists for selection (-m remote) and to
    # document the hermeticity guarantee, not to gate on connectivity.
    config.addinivalue_line(
        "markers",
        "remote: remote-backend tests against the hermetic loopback range "
        "server (no external network access)",
    )
    # Tier-2 concurrency stress: threaded/async consistency tests with
    # internal join timeouts (select with `-m stress`). They also run in the
    # plain tier-1 invocation — the marker exists for targeted selection and
    # for CI lanes that want only the concurrency suite, not to hide tests.
    config.addinivalue_line(
        "markers",
        "stress: tier-2 threaded/async consistency stress tests (bounded by "
        "in-test timeouts; `-m stress` selects just these)",
    )
    # Gateway tests talk HTTP only to an in-process loopback GatewayServer
    # (src/repro/service/gateway/) — hermetic like the `remote` marker, so
    # tier-1 stays offline-safe; `-m gateway` selects just the wire suite.
    config.addinivalue_line(
        "markers",
        "gateway: HTTP gateway tests against an in-process loopback "
        "GatewayServer (no external network access)",
    )
    # Kernel interpret-mode tests (Pallas kernels + the batched device
    # engine) run the kernel bodies in Python — correct but slow. The marker
    # gives them a selection handle: `-m kernels` for the kernel lane,
    # `-m "not kernels"` for a fast CPU-only pass. They still run in plain
    # tier-1; the tier-2 perf gate is
    # `python -m benchmarks.run --smoke --only kernels,codecs` (ROADMAP).
    config.addinivalue_line(
        "markers",
        "kernels: Pallas interpret-mode kernel/engine tests (slow kernel-"
        "body interpretation; `-m kernels` selects just these)",
    )
    # Zstd tests exercise real seekable frames when a library is importable
    # (stdlib compression.zstd on 3.14+, else the optional zstandard extra —
    # see requirements-test.txt) and must skip cleanly on a bare container.
    config.addinivalue_line(
        "markers",
        "zstd: tests needing a zstd library (compression.zstd or zstandard);"
        " auto-skipped when neither is importable",
    )
    config.addinivalue_line("markers", "cuda: repro_torch tests that need a CUDA device and nvcc; skipped without them")


def pytest_collection_modifyitems(config, items):
    from repro.core.codec import have_zstd

    if have_zstd():
        return
    skip_zstd = pytest.mark.skip(
        reason="no zstd library (compression.zstd needs Python 3.14+; "
        "`pip install zstandard` for older interpreters)"
    )
    for item in items:
        if "zstd" in item.keywords:
            item.add_marker(skip_zstd)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


class CodecCase:
    """One codec's test surface: its tag and a matching compressor."""

    def __init__(self, tag, compress):
        self.tag = tag
        self.compress = compress

    def __repr__(self):
        return "CodecCase(%s)" % self.tag


def _codec_cases():
    from repro.core.synth import bgzf_compress, gzip_compress, zstd_seekable_compress

    cases = {
        "deflate": CodecCase("deflate", lambda d: gzip_compress(d, 6)),
        "bgzf": CodecCase("bgzf", lambda d: bgzf_compress(d, 6)),
        "zstd": CodecCase("zstd", lambda d: zstd_seekable_compress(d, 3)),
    }
    return cases


@pytest.fixture(
    params=[
        "deflate",
        "bgzf",
        pytest.param("zstd", marks=pytest.mark.zstd),
    ]
)
def codec_case(request):
    """Parametrizes a test over all three codecs (zstd auto-skips when no
    library is importable). Yields a CodecCase: ``.tag`` for assertions and
    ``.compress(data)`` to build a matching archive."""
    return _codec_cases()[request.param]


def make_text(rng, n: int) -> bytes:
    """Compressible text-like data (dynamic blocks, plenty of backrefs)."""
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"rapidgzip", b"parallel", b"deflate", b"window"]
    idx = rng.integers(0, len(words), size=max(8, n // 4))
    out = b" ".join(words[i] for i in idx)
    return out[:n]


def make_base64(rng, n: int) -> bytes:
    import base64

    raw = rng.integers(0, 256, (n * 3) // 4 + 3, dtype=np.uint8).tobytes()
    return base64.b64encode(raw)[:n]


def make_random(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def gzip_bytes(data: bytes, level: int = 6) -> bytes:
    return _gzip.compress(data, compresslevel=level)
