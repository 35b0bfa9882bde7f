"""TorchDecodeEngine: the stage-2 resolver of repro_torch.

Ports the core of ``test_device_engine.py`` to ``device="cpu"`` (the
kernels' plain versions): ragged sizes, multi-window coalescing, slabbing,
CRC parity with zlib, routing, shutdown, and the stats surface, all exact
against the reference host path and the reference engine. The engine on
the card is tested in ``test_torch_cuda.py``.
"""

import threading
import zlib

import numpy as np
import pytest
import torch

from repro.core.markers import replace_markers as cpu_replace
from repro.kernels.engine import DeviceDecodeEngine
from repro.kernels.engine import derive_crossover as ref_derive_crossover
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import marker_replace as tmr
from repro_torch.kernels.engine import (
    EngineClosedError,
    TorchDecodeEngine,
    derive_crossover,
)

TABLE_SIZE = 256 + 32768


def make_engine(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("max_delay_s", 0.005)
    return TorchDecodeEngine(**kw)


def make_syms(rng, n):
    return rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)


def make_window(rng, n=32768):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def make_random(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def rng(request):
    return np.random.default_rng(list(request.node.name.encode()))


# ---------------------------------------------------------------------------
# replace parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 100, 8191, 8192, 8193, 3 * 8192 + 17])
def test_replace_parity_ragged_sizes(rng, n):
    with make_engine() as eng:
        syms = make_syms(rng, n)
        window = make_window(rng)
        out = eng.submit_replace(syms, window).result(timeout=60)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, cpu_replace(syms, window))


@pytest.mark.parametrize("wlen", [0, 1, 300, 32768, 40000])
def test_replace_parity_window_lengths(rng, wlen):
    window = make_window(rng, wlen)
    if wlen == 0:
        syms = rng.integers(0, 256, 500, dtype=np.int64).astype(np.uint16)
    else:
        lo = 256 + (32768 - min(wlen, 32768))
        syms = rng.integers(lo, TABLE_SIZE, 500, dtype=np.int64).astype(np.uint16)
    with make_engine() as eng:
        out = eng.submit_replace(syms, window).result(timeout=60)
        np.testing.assert_array_equal(out, cpu_replace(syms, window))


def test_replace_oversized_request_spans_slabs(rng):
    """A request larger than max_batch_tiles is slabbed across several
    launches and reassembled in order."""
    with make_engine(max_batch_tiles=2) as eng:
        syms = make_syms(rng, 5 * 8192 + 123)  # 6 tiles > 2-tile slabs
        window = make_window(rng)
        out = eng.submit_replace(syms, window).result(timeout=60)
        np.testing.assert_array_equal(out, cpu_replace(syms, window))
        assert eng.stats()["dispatches"] >= 3


def test_replace_uint8_passthrough(rng):
    with make_engine() as eng:
        data = np.frombuffer(make_random(rng, 100), np.uint8)
        np.testing.assert_array_equal(eng.submit_replace(data, b"").result(timeout=60), data)
        assert eng.stats()["batches"] == 0


def test_interleaved_multi_tenant_batches(rng):
    """Concurrent submitters with distinct windows coalesce into shared
    dispatches and every result matches its own window's host gather."""
    with make_engine(max_delay_s=0.02, max_batch_tiles=32) as eng:
        windows = [make_window(rng) for _ in range(3)]
        cases = [(make_syms(rng, 2000 + 37 * i), windows[i % 3]) for i in range(24)]
        results = [None] * len(cases)
        errors = []

        def submit(lo, hi):
            try:
                futs = [(j, eng.submit_replace(*cases[j])) for j in range(lo, hi)]
                for j, f in futs:
                    results[j] = f.result(timeout=60)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(t * 8, (t + 1) * 8)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        for (syms, window), out in zip(cases, results):
            np.testing.assert_array_equal(out, cpu_replace(syms, window))
        stats = eng.stats()
        assert stats["batched_requests"] == len(cases)
        assert stats["batches"] < len(cases)
        assert stats["occupancy"] > 0.0


def test_more_windows_than_max_tables_split_batches(rng):
    """Ten distinct windows against max_tables=4: a batch never carries more
    than four tables, and every request still resolves exactly."""
    with make_engine(max_delay_s=0.05, max_tables=4, max_batch_tiles=64) as eng:
        cases = [(make_syms(rng, 3000), make_window(rng)) for _ in range(10)]
        futs = [eng.submit_replace(s, w) for s, w in cases]
        for (syms, window), fut in zip(cases, futs):
            np.testing.assert_array_equal(fut.result(timeout=60), cpu_replace(syms, window))
        shapes = eng.dispatch_shapes()
        assert max(k[2] for k in shapes if k[0] == "replace") <= 4
        assert eng.stats()["batches"] >= 3


def test_parity_with_reference_engine(rng):
    """Same requests through the JAX engine (interpret mode) and this one."""
    cases = [(make_syms(rng, n), make_window(rng)) for n in (10, 8192 + 5)]
    blobs = [make_random(rng, n) for n in (77, 5000)]
    ref = DeviceDecodeEngine(force_device=True, crossover=None, max_delay_s=0.005)
    try:
        with make_engine() as eng:
            for syms, window in cases:
                np.testing.assert_array_equal(
                    eng.replace_markers(syms, window), ref.replace_markers(syms, window)
                )
            for blob in blobs:
                assert eng.crc32(blob) == ref.crc32(blob)
    finally:
        ref.shutdown()


# ---------------------------------------------------------------------------
# crc parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 4096, 50_000])
def test_crc_parity_sizes(rng, n):
    blob = make_random(rng, n)
    with make_engine() as eng:
        assert eng.submit_crc(blob).result(timeout=60) == (zlib.crc32(blob) & 0xFFFFFFFF)


def test_crc_accepts_ndarray(rng):
    arr = np.frombuffer(make_random(rng, 5000), np.uint8)
    with make_engine() as eng:
        assert eng.crc32(arr) == (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF)


def test_crc_batch_of_mixed_sizes(rng):
    blobs = [make_random(rng, n) for n in (10, 1024, 3333, 20_000)]
    with make_engine(max_delay_s=0.02) as eng:
        futs = [eng.submit_crc(b) for b in blobs]
        for blob, fut in zip(blobs, futs):
            assert fut.result(timeout=60) == (zlib.crc32(blob) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# routing / crossover
# ---------------------------------------------------------------------------

def test_default_routes_every_request_to_the_kernels(rng):
    """No crossover: every non-degenerate request is batched, none falls
    back, and the launches happen through the wrappers' plain versions
    (CPU tensors), not the CUDA kernels."""
    tmr.reset_launches()
    tcrc.reset_launches()
    with make_engine() as eng:
        syms, window = make_syms(rng, 5000), make_window(rng)
        np.testing.assert_array_equal(eng.replace_markers(syms, window), cpu_replace(syms, window))
        blob = make_random(rng, 10_000)
        assert eng.crc32(blob) == (zlib.crc32(blob) & 0xFFFFFFFF)
        stats = eng.stats()
        assert stats["force_device"] and stats["interpret"]
        assert stats["fallbacks"] == {"replace": 0, "crc": 0}
        assert stats["batches"] == 2 and stats["errors"] == 0
    assert tmr.launches == 0 and tcrc.launches == 0


def test_explicit_crossover_routes_by_size(rng):
    with make_engine(crossover={"replace": 4096, "crc": None}) as eng:
        assert not eng.force_device
        small, big, window = make_syms(rng, 100), make_syms(rng, 8192), make_window(rng)
        np.testing.assert_array_equal(eng.replace_markers(small, window), cpu_replace(small, window))
        np.testing.assert_array_equal(eng.replace_markers(big, window), cpu_replace(big, window))
        stats = eng.stats()
        assert stats["fallbacks"]["replace"] == 1
        assert stats["batches"] == 1


DERIVE_CASES = [
    [
        {"name": "kernel_engine_cpu_replace", "value_us": 50.0, "derived": "100MB/s"},
        {"name": "kernel_engine_batched_b16", "value_us": 100.0, "derived": "400MB/s"},
        {"name": "kernel_engine_batched_b1", "value_us": 120.0, "derived": "70MB/s"},
    ],
    [
        {"name": "kernel_engine_cpu_replace", "value_us": 10.0, "derived": "500MB/s"},
        {"name": "kernel_engine_batched_b16", "value_us": 5000.0, "derived": "30MB/s"},
        {"name": "kernel_engine_batched_b1", "value_us": 700.0, "derived": "11MB/s"},
    ],
    [
        {"name": "kernel_engine_cpu_crc", "value_us": 10.0, "derived": "800MB/s"},
        {"name": "kernel_engine_crc_batched_b8", "value_us": 50.0, "derived": "9000MB/s"},
        {"name": "kernel_engine_crc_batched_b1", "value_us": 30.0, "derived": "500MB/s"},
    ],
    [],
]


@pytest.mark.parametrize("case", range(len(DERIVE_CASES)))
def test_derive_crossover_matches_reference(case):
    rows = DERIVE_CASES[case]
    assert derive_crossover(rows) == ref_derive_crossover(rows)


def test_derive_crossover_math():
    out = derive_crossover(DERIVE_CASES[0])
    assert 8_000 < out["replace"] < 20_000
    assert out["crc"] is None
    assert derive_crossover(DERIVE_CASES[1])["replace"] is None


# ---------------------------------------------------------------------------
# errors and lifecycle
# ---------------------------------------------------------------------------

def test_cuda_engine_raises_without_cuda(monkeypatch):
    """No silent degradation: without a CUDA device the default engine
    refuses to construct instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDecodeEngine()


def test_unknown_device_is_refused():
    with pytest.raises(ValueError):
        TorchDecodeEngine(device="meta")


def test_dispatch_error_fails_only_that_batch(rng, monkeypatch):
    with make_engine() as eng:
        real = eng._dispatch_replace
        calls = []

        def flaky(reqs):
            calls.append(len(reqs))
            if len(calls) == 1:
                raise RuntimeError("launch failed")
            return real(reqs)

        monkeypatch.setattr(eng, "_dispatch_replace", flaky)
        syms, window = make_syms(rng, 300), make_window(rng)
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.submit_replace(syms, window).result(timeout=60)
        np.testing.assert_array_equal(
            eng.submit_replace(syms, window).result(timeout=60), cpu_replace(syms, window)
        )
        stats = eng.stats()
        assert stats["errors"] == 1
        assert stats["fallbacks"] == {"replace": 0, "crc": 0}


def test_shutdown_errors_queued_futures(rng):
    eng = make_engine(max_delay_s=0.5)  # long coalescing window: stay queued
    futs = [eng.submit_replace(make_syms(rng, 1000), make_window(rng)) for _ in range(8)]
    eng.shutdown()
    errored = completed = 0
    for f in futs:
        try:
            out = f.result(timeout=10)
        except EngineClosedError:
            errored += 1
        else:
            assert out.dtype == np.uint8
            completed += 1
    assert errored + completed == len(futs)
    assert errored > 0


def test_submit_after_shutdown_raises(rng):
    eng = make_engine()
    eng.shutdown()
    with pytest.raises(EngineClosedError):
        eng.submit_replace(make_syms(rng, 1000), b"")
    with pytest.raises(EngineClosedError):
        eng.submit_crc(b"data")
    # the blocking surface serves on the CPU and counts it as a fallback
    syms = make_syms(rng, 1000)
    np.testing.assert_array_equal(eng.replace_markers(syms, b""), cpu_replace(syms, b""))
    assert eng.crc32(b"data") == (zlib.crc32(b"data") & 0xFFFFFFFF)
    assert eng.stats()["fallbacks"] == {"replace": 1, "crc": 1}


def test_shutdown_idempotent():
    eng = make_engine()
    eng.shutdown()
    eng.shutdown()
    assert eng.stats()["closed"]


def test_stats_keys_match_reference():
    ref = DeviceDecodeEngine(force_device=True, crossover=None)
    try:
        with make_engine() as eng:
            assert set(eng.stats()) == set(ref.stats())
            for key in ("requests", "fallbacks", "crossover_bytes"):
                assert set(eng.stats()[key]) == set(ref.stats()[key])
    finally:
        ref.shutdown()
