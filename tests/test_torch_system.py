"""The port's deployment loop on the CPU: gzip corpus -> pipeline -> train ->
preempt -> restore (model, optimizer AND data position) -> continue, through
the library (test_system.py's end-to-end test), the launch driver run twice
against one checkpoint directory, and the training example."""

import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import GzipCorpusDataset
from repro_torch.launch import train as launch
from repro_torch.launch.train import make_corpus
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _dataset(shards):
    return GzipCorpusDataset(shards, seq_len=64, batch_size=4, parallelization=2,
                             chunk_size=64 << 10, device="cpu")


def test_end_to_end_train_checkpoint_resume(tmp_path):
    """test_system.py::test_end_to_end_train_checkpoint_resume on the port,
    and more: the 10 batches after the restore equal an unbroken run's, and
    so do its losses (the same arithmetic from the same state on the CPU)."""
    corpus = str(tmp_path / "corpus")
    make_corpus(corpus, n_shards=2, shard_bytes=256 << 10)
    shards = sorted(glob.glob(os.path.join(corpus, "*.gz")))

    cfg = smoke_config(get_config("granite-3-2b"))
    ocfg = AdamWConfig(peak_lr=3e-3, warmup_steps=3, total_steps=40)
    model = build_model(cfg, device="cpu")
    ds = _dataset(shards)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0))
    step_fn = make_train_step(model, ocfg)

    losses, batches = [], []
    ckpt = str(tmp_path / "ckpt")
    for step in range(20):
        batch = ds.next_batch()
        batches.append(batch["tokens"])
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if step == 9:
            save_checkpoint(ckpt, 10, {"params": params, "opt": opt, "data": ds.state_dict()})

    # simulate losing the process: fresh states, restore everything
    model2 = build_model(cfg, device="cpu")
    params2, opt2 = init_train_state(model2, torch.Generator().manual_seed(123))
    ds2 = _dataset(shards)
    s, state = restore_checkpoint(latest_checkpoint(ckpt),
                                  {"params": params2, "opt": opt2, "data": ds2.state_dict()})
    assert s == 10
    ds2.load_state_dict(state["data"])
    opt2 = state["opt"]
    step_fn2 = make_train_step(model2, ocfg)
    resumed = []
    for step in range(10, 20):
        batch = ds2.next_batch()
        assert np.array_equal(batch["tokens"], batches[step]), step
        params2, opt2, m = step_fn2(params2, opt2, batch)
        resumed.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(resumed, losses[10:], rtol=1e-5)
    ds.close()
    ds2.close()


def _driver(tmp_path, steps, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--ckpt", str(tmp_path / "ckpt"), "--ckpt-every", "3",
            "--corpus", str(tmp_path / "corpus"), *extra]
    return subprocess.run(args, env=env, capture_output=True, text=True, timeout=600)


def test_driver_trains_checkpoints_and_resumes(tmp_path):
    """The driver twice: 6 steps with a checkpoint every 3, then a second
    run to 9 steps that restores step 6 (model, optimizer, data) first."""
    first = _driver(tmp_path, 6)
    assert first.returncode == 0, first.stderr
    assert "[train] checkpoint @ step 6" in first.stdout
    assert "[train] done: 6144 tokens" in first.stdout
    second = _driver(tmp_path, 9)
    assert second.returncode == 0, second.stderr
    assert "[train] restored step 6 from" in second.stdout
    assert "[train] checkpoint @ step 9" in second.stdout
    assert latest_checkpoint(str(tmp_path / "ckpt")).endswith("step_00000009")


@pytest.mark.parametrize("arch,extra", [("granite-3-2b", ["--grad-accum", "2",
                                                          "--compress-grads"]),
                                        ("whisper-tiny", ["--profile-steps", "1"])])
def test_driver_run_returns_what_it_measured(tmp_path, arch, extra):
    """run(args) as chip_smoke.py drives it: per-step losses and seconds, the
    data share, where parameters, moments and gradients lived; whisper's
    batches carry stub frames."""
    args = launch.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32", "--corpus", str(tmp_path / "corpus"), *extra])
    lines = []
    out = launch.run(args, log=lines.append)
    assert len(out["losses"]) == len(out["step_s"]) == len(out["data_s"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert 0 < out["data_share"] < 1
    assert out["devices"] == {"params": ["cpu"], "moments": ["cpu"], "grads": ["cpu"]}
    assert out["params"] == smoke_config(get_config(arch)).param_count()
    assert lines[-1].startswith("[train] done:")
    if "--profile-steps" in extra:
        assert out["profile"]["steps"] == 1


def test_example_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
                           "--device", "cpu", "--steps", "40", "--resume-demo"],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "model granite-demo-20m: 4.1M params on cpu" in proc.stdout
    assert "simulating preemption at step 21" in proc.stdout
    assert "(decreased)" in proc.stdout
