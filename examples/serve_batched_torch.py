"""Batched serving demo on PyTorch: prefill a batch of prompts, then
greedy-decode against caches updated in place, while the same process
serves corpus range-reads out of gzip shards through the archive service
(retrieval-style traffic: each decoded sequence fetches a context document
by decompressed offset), whose stage 2 runs on the server's engine.

The counterpart of ``examples/serve_batched.py``, step for step, on
``repro_torch``: the model and the archive server run on the card by
default (``--device cpu`` runs both on the host).

    PYTHONPATH=src python examples/serve_batched_torch.py --arch gemma-2b
    PYTHONPATH=src python examples/serve_batched_torch.py --no-corpus   # model only
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu --no-corpus
    PYTHONPATH=src python examples/serve_batched_torch.py --arch granite-3-2b --full-width
"""

import argparse
import gzip as _gzip
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import all_configs, smoke_config
from repro_torch.models import build_model
from repro_torch.serve import make_serve_steps, prefill_to_decode_caches
from repro_torch.service import ArchiveServer, IndexStore, format_summary


def make_corpus_service(tmpdir: str, *, n_shards: int = 3, shard_mb: float = 1.0,
                        device: str = "cuda"):
    """Gzip corpus shards + an ArchiveServer over them (warm-capable)."""
    rng = np.random.default_rng(7)
    words = [b"the", b"quick", b"brown", b"fox", b"rapidgzip", b"serve",
             b"retrieval", b"document", b"context", b"window"]
    paths, sizes = [], []
    for s in range(n_shards):
        n = int(shard_mb * (1 << 20))
        doc = b" ".join(words[i] for i in rng.integers(0, len(words), n // 6))[:n]
        path = os.path.join(tmpdir, f"corpus-{s:02d}.txt.gz")
        with open(path, "wb") as f:
            f.write(_gzip.compress(doc, 6))
        paths.append(path)
        sizes.append(len(doc))
    server = ArchiveServer(
        max_workers=4,
        cache_budget_bytes=8 << 20,  # far below n_shards x per-reader maxima
        index_store=IndexStore(os.path.join(tmpdir, "indexes")),
        chunk_size=256 << 10,
        device=device,
    )
    handles = [server.open(p, tenant="serve") for p in paths]
    return server, handles, sizes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(all_configs()))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--no-corpus", action="store_true",
                    help="skip the archive-service corpus demo")
    ap.add_argument("--corpus-shards", type=int, default=3)
    ap.add_argument("--corpus-mb", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the archive server's stage 2 run")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of its smoke-width reduction")
    args = ap.parse_args()

    cfg = all_configs()[args.arch]
    if not args.full_width:
        cfg = smoke_config(cfg)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    model.init(gen)

    B, P, N = args.batch, args.prompt_len, args.new_tokens
    max_len = P + N + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32)).to(model.device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(
            rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        ).to(model.device, torch.bfloat16)

    t0 = time.perf_counter()
    logits, pc = prefill_fn(batch)
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, P + prefix)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    tok_host = tok.cpu().numpy()
    t_prefill = time.perf_counter() - t0
    print(f"prefill {B}x{P}: {t_prefill*1e3:.0f} ms")

    corpus = None
    corpus_dir = None
    if not args.no_corpus:
        corpus_dir = tempfile.TemporaryDirectory(prefix="serve_corpus_")
        corpus = make_corpus_service(
            corpus_dir.name, n_shards=args.corpus_shards, shard_mb=args.corpus_mb,
            device=args.device,
        )

    generated = [tok_host]
    doc_bytes = 0
    t0 = time.perf_counter()
    for t in range(N - 1):
        tok, _, caches = decode_fn(tok, caches, P + prefix + t)
        tok_host = tok.cpu().numpy()
        generated.append(tok_host)
        if corpus is not None:
            # Retrieval-style traffic interleaved with decode: each sequence
            # pulls a context snippet addressed by decompressed offset.
            server, handles, sizes = corpus
            for b in range(B):
                shard = (b + t) % len(handles)
                off = int(tok_host[b, 0]) * 1009 % max(1, sizes[shard] - 512)
                doc_bytes += len(server.read_range(handles[shard], off, 512))
    dt = time.perf_counter() - t0
    out = np.concatenate(generated, axis=1)
    print(f"decode {N-1} steps: {dt*1e3:.0f} ms "
          f"({B*(N-1)/dt:.1f} tok/s batched, greedy)")
    for b in range(B):
        print(f"  seq {b}: {out[b][:16].tolist()}...")

    if corpus is not None:
        server, handles, _ = corpus
        print(f"\ncorpus service: {doc_bytes/1e3:.0f} kB of context served "
              f"during decode, budget-shared across {len(handles)} shards")
        print(format_summary(server.metrics()))
        server.shutdown()
        corpus_dir.cleanup()


if __name__ == "__main__":
    main()
