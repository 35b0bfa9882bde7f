"""A run of each cell driven at a small size on the host, the look for a
card skipped: sound, it is correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (a step that returns its state unchanged, half of the batch left
out, a token or an answer altered where it is produced, a guarantee the
configuration states left unchecked; there is no exchange between chips
on one card)."""

import time

import pytest

from portbench import harness

def run_small(cell: str, seconds: float = 1.0):
    m = harness.Manifest()
    c = m.cell(cell)
    tr = m.traffic(c["traffic"])
    cfg, tr = harness.driver(tr["driver"]).small(m.config(c["config"]), tr)
    return harness.run_cell(m, cell, seed=2 ** 31 + 99, seconds=seconds, trace=False,
                            device="cpu", t_start=time.monotonic(), config=cfg, traffic=tr)


def test_read_sound_and_a_byte_altered(monkeypatch):
    assert run_small("read.b64-gzip").correct
    from repro_torch.core import reader

    real = reader.ParallelGzipReader._read_span

    def altered(self, pos, end):
        data = bytearray(real(self, pos, end))
        if data:
            data[len(data) // 2] ^= 0x20
        return bytes(data)

    monkeypatch.setattr(reader.ParallelGzipReader, "_read_span", altered)
    run = run_small("read.b64-gzip")
    assert not run.correct and run.checks["mismatched_bytes"]["value"] > 0


@pytest.mark.parametrize("field", ["crc32", "isize"])
def test_read_trailer_unverified(monkeypatch, field):
    """The reader's CRC and size compare switched off: every byte still
    reads right, and only the altered trailer's read shows the fault."""
    from portbench.drivers import read_whole
    from repro_torch.core import reader

    real = reader.ParallelGzipReader.__init__

    def unverified(self, *args, **kw):
        real(self, *args, **kw)
        self._verify = False

    monkeypatch.setattr(reader.ParallelGzipReader, "__init__", unverified)
    monkeypatch.setattr(read_whole, "altered_trailer", lambda seed: (field, 5))
    run = run_small("read.b64-gzip")
    assert not run.correct
    assert run.checks["mismatched_bytes"]["value"] == 0
    assert run.checks["altered_trailer_not_refused"]["value"] == 1


def test_train_sound():
    run = run_small("train.granite-3-2b")
    assert run.correct, run.checks


def test_train_state_unchanged(monkeypatch):
    from repro_torch.train import train_step

    def unchanged(cfg, params, grads, state, **kw):
        return params, dict(state, step=state["step"] + 1), {"lr": 0.0, "grad_norm": 0.0}

    monkeypatch.setattr(train_step, "adamw_update", unchanged)
    run = run_small("train.granite-3-2b")
    assert not run.correct
    assert run.checks["change_gap_median_leaf"]["value"] == pytest.approx(1.0, abs=0.01)


def test_train_half_the_batch(monkeypatch):
    from repro_torch.models import model

    real = model.Model.loss

    def half(self, batch, ctx=None):
        rows = batch["tokens"].shape[0] // 2
        return real(self, {k: v[:rows] for k, v in batch.items()}, ctx)

    monkeypatch.setattr(model.Model, "loss", half)
    run = run_small("train.granite-3-2b")
    assert not run.correct, run.checks


def test_train_token_altered(monkeypatch):
    from repro_torch.data import pipeline

    real = pipeline.GzipCorpusDataset.next_batch

    def altered(self):
        batch = real(self)
        batch["tokens"][0, 7] = (batch["tokens"][0, 7] + 1) % 256
        return batch

    monkeypatch.setattr(pipeline.GzipCorpusDataset, "next_batch", altered)
    run = run_small("train.granite-3-2b")
    assert not run.correct and run.checks["batch_token_mismatch"]["value"] > 0


def test_decode_sound():
    run = run_small("decode.granite-3-2b")
    assert run.correct, run.checks


def test_decode_token_altered(monkeypatch):
    from repro_torch.serve import serve_step

    real = serve_step.make_serve_steps

    def altered(*args, **kw):
        prefill_fn, decode_fn, caches = real(*args, **kw)

        def wrong(tokens, caches, pos):
            nxt, logits, caches = decode_fn(tokens, caches, pos)
            return (nxt + 1) % 256, logits, caches

        return prefill_fn, wrong, caches

    monkeypatch.setattr(serve_step, "make_serve_steps", altered)
    run = run_small("decode.granite-3-2b")
    assert not run.correct, run.checks
