"""End-to-end LM training on a gzip-compressed corpus, on repro_torch.

The port's counterpart of ``examples/train_lm.py``, with the same flags plus
``--device`` (``cuda`` by default: the model, and stage 2 of the corpus
reads, run on the card; ``cpu`` runs both on the host). Default settings
train a small granite-family model (4 layers x 256) for 120 steps;
``--full`` switches to a ~100M-parameter config. Demonstrates the whole
stack: parallel gzip decompression -> tokenize/pack -> train step ->
checkpoint -> restore.

    PYTHONPATH=src python examples/train_lm_torch.py
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 40 --resume-demo
    PYTHONPATH=src python examples/train_lm_torch.py --full --steps 300
"""

import argparse
import dataclasses
import glob
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import GzipCorpusDataset
from repro_torch.launch.train import make_corpus
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, init_train_state, make_train_step


def model_config(full: bool):
    base = get_config("granite-3-2b")
    if not full:
        return dataclasses.replace(
            smoke_config(base), name="granite-demo-20m",
            n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
            vocab_size=512,
        )
    # ~100M-parameter config (12L x 768)
    return dataclasses.replace(
        base, name="granite-demo-100m",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
        vocab_size=32768, tie_embeddings=True, attn_q_chunk=256,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--resume-demo", action="store_true",
                    help="kill-and-restore mid-run to demo fault tolerance")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = model_config(args.full)
    model = build_model(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params on {model.device}")

    corpus = os.path.join(tempfile.gettempdir(), "repro_torch_corpus_demo")
    make_corpus(corpus, n_shards=2, shard_bytes=2 << 20)
    shards = sorted(glob.glob(os.path.join(corpus, "*.gz")))
    ds = GzipCorpusDataset(shards, seq_len=args.seq, batch_size=args.batch,
                           parallelization=4, chunk_size=256 << 10, device=args.device)

    def generator(seed):
        return torch.Generator(device=model.device).manual_seed(seed)

    params, opt = init_train_state(model, generator(0))
    step_fn = make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                                 total_steps=args.steps))

    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_demo")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    halfway = args.steps // 2
    losses = []
    for step in range(args.steps):
        batch = ds.next_batch()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f}")
        if args.resume_demo and step == halfway:
            save_checkpoint(ckpt_dir, step + 1, {"params": params, "opt": opt,
                                                 "data": ds.state_dict()})
            print(f"--- simulating preemption at step {step+1}: "
                  f"restoring everything from checkpoint ---")
            params, opt = init_train_state(model, generator(99))
            s, state = restore_checkpoint(latest_checkpoint(ckpt_dir),
                                          {"params": params, "opt": opt, "data": ds.state_dict()})
            opt = state["opt"]
            ds.load_state_dict(state["data"])
            assert s == step + 1

    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'decreased' if losses[-1] < losses[0] else 'NOT decreased'})")
    ds.close()


if __name__ == "__main__":
    main()
