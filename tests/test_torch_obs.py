"""The port's own spans, on the host: a small gzip read records stage 1
(``fetcher.task``), the caller's waits (``reader.chunk_wait``,
``reader.verify``) and the engine's CRC fold (``engine.crc_fold``) with
their parents; a train step its forward, backward and optimizer; a decode
step its dispatch. With tracing off the ring stays empty."""

import base64
import gzip
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import all_configs, smoke_config
from repro_torch.core.reader import ParallelGzipReader
from repro_torch.kernels.engine import TorchDecodeEngine
from repro_torch.models import build_model
from repro_torch.obs import trace
from repro_torch.serve.serve_step import make_serve_steps
from repro_torch.train import AdamWConfig, init_train_state, make_train_step


@pytest.fixture
def tracing():
    trace.disable_tracing()
    trace.reset_tracing()
    yield trace
    trace.disable_tracing()
    trace.reset_tracing()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    data = base64.encodebytes(np.random.default_rng(26).bytes(150_000))
    path = tmp_path_factory.mktemp("obs") / "f.gz"
    path.write_bytes(gzip.compress(data, 6))
    return str(path), data


def _read(path):
    engine = TorchDecodeEngine(device="cpu")
    try:
        with ParallelGzipReader(path, resolver=engine, parallelization=2, chunk_size=64 << 10,
                                index_spacing=64 << 10) as r:
            return r.read()
    finally:
        engine.shutdown()


def test_read_records_stage1_waits_and_the_fold(tracing, archive):
    path, data = archive
    tracing.enable_tracing(1 << 16)
    assert _read(path) == data
    assert tracing.tracing_stats()["dropped"] == 0
    spans = tracing.drain_spans()
    by_id = {s["span_id"]: s for s in spans}

    def named(name):
        return [s for s in spans if s["name"] == name]

    def parent(s):
        return by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id else None

    me = threading.get_ident()
    waits, verifies, folds = named("reader.chunk_wait"), named("reader.verify"), \
        named("engine.crc_fold")
    assert waits and verifies and folds and named("fetcher.task")
    assert {parent(s) for s in waits} == {"reader.frontier_wait"}
    assert {parent(s) for s in verifies} == {"reader.frontier_wait"}
    assert {s["thread"] for s in waits + verifies} == {me}
    # The caller waits for each CRC inside the verify span; the engine's
    # dispatcher folds the lanes on its own thread, for any requester.
    crc_waits = [s for s in named("engine.batch_wait") if s["attrs"].get("kind") == "crc"]
    assert crc_waits and {parent(s) for s in crc_waits} == {"reader.verify"}
    assert {s["thread_name"] for s in folds} == {"torch-decode-engine"}
    assert all(s["parent_id"] is None for s in folds)
    # Stage 1 runs in the pool, under the wait that asked for it.
    tasks = named("fetcher.task")
    assert all(s["thread"] != me for s in tasks)
    assert "reader.chunk_wait" in {parent(s) for s in tasks}


def test_read_with_tracing_off_leaves_the_ring_empty(tracing, archive):
    path, data = archive
    assert _read(path) == data
    assert tracing.tracing_stats()["recorded_total"] == 0
    assert tracing.recorded_spans() == []


@pytest.fixture(scope="module")
def granite():
    cfg = smoke_config(all_configs()["granite-3-2b"])
    return cfg, build_model(cfg, device="cpu")


def test_train_step_records_its_phases(tracing, granite):
    cfg, model = granite
    params, opt = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10))
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17),
                                                         dtype=np.int32)}
    tracing.enable_tracing()
    step(params, opt, batch)
    spans = sorted(tracing.drain_spans(), key=lambda s: s["ts"])
    names = [s["name"] for s in spans if s["name"].startswith("train.")]
    assert names == ["train.forward", "train.backward", "train.optimizer"]
    assert {s["thread"] for s in spans if s["name"] in names} == {threading.get_ident()}


def test_decode_step_records_its_dispatch(tracing, granite):
    cfg, model = granite
    model.init(torch.Generator().manual_seed(1))
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=2, max_len=12)
    caches = model.init_decode_caches(2, 12, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    tracing.enable_tracing()
    for pos in range(3):
        tok, _, _ = decode_fn(tok, caches, pos)
    spans = tracing.drain_spans()
    steps = [s for s in spans if s["name"] == "serve.decode_step"]
    assert len(steps) == 3 and all(s["dur_s"] > 0 for s in steps)
    trace.disable_tracing()
    decode_fn(tok, caches, 3)
    assert tracing.recorded_spans() == []
