"""End-to-end training driver: gzip corpus -> parallel decompression ->
tokens -> train step on the card, with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-3-2b --smoke --steps 50 --corpus /tmp/corpus \
        --ckpt /tmp/ckpt --ckpt-every 20

The counterpart of ``repro.launch.train``: the same flags and printed
lines, plus ``--device`` (``cuda`` by default, where stage 2 of the corpus
reads and the model both run; ``cpu`` on request), ``--seed`` (the weights'
generator; the JAX driver's key is 0), ``--layers`` (a cut of the config's
depth) and ``--profile-steps``. On restart the
driver restores model and optimizer state AND the data-pipeline seek state
(O(1) thanks to the gzip seek index: the paper's random-access capability
is what makes a data restart cheap). ``run(args)`` is the loop, returning
what it measured; ``main`` parses the flags and prints.

As the JAX driver does, it trains on ``make_host_mesh()`` with
``default_rules``: every rank of the process group on (data, model) =
(world, 1). In one process that is a group of one rank (NCCL on the card,
gloo on the host), where the step computes what the one-device step
computes; under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`` it is N ranks of data parallelism with
ZeRO-1. Every rank reads the same global batch from its own
``GzipCorpusDataset`` and the step takes the rank's rows
(``batch_partition``), so the batches are the JAX driver's and the
one-rank run's and need no collective. Only rank 0 logs and writes
checkpoints (every rank takes part in gathering them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..configs import all_configs, get_config, smoke_config
from ..data import GzipCorpusDataset
from ..distributed import default_rules
from ..distributed.sharding import NamedSharding, P
from ..models import build_model
from ..models.layers import tree_tensors
from ..train import AdamWConfig, init_train_state, make_train_step
from .mesh import make_host_mesh


def make_corpus(directory: str, n_shards: int = 2, shard_bytes: int = 1 << 20) -> None:
    """Synthesize a small gzip text corpus if none exists."""
    import gzip as _gzip

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"training", b"corpus", b"gzip", b"parallel"]
    for i in range(n_shards):
        path = os.path.join(directory, f"shard_{i:03d}.gz")
        if os.path.exists(path):
            continue
        idx = rng.integers(0, len(words), shard_bytes // 5)
        data = b" ".join(words[j] for j in idx)[:shard_bytes]
        with open(path, "wb") as f:
            f.write(_gzip.compress(data, 6))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite-3-2b", choices=sorted(all_configs()))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--corpus", default=os.path.join(tempfile.gettempdir(), "repro_corpus"))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--decomp-parallelism", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the model and stage 2 of the corpus reads run (cuda | cpu)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights (and stub inputs)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: the config's)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="run the last N steps under torch.profiler and report device time")
    return ap


def stub_inputs(cfg, batch: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The stub frontends' embeddings a batch of the audio (``frames``) or
    vlm (``patches``) family carries beside its tokens, drawn at random."""
    shape = {"audio": ("frames", cfg.encoder_frames), "vlm": ("patches", cfg.vision_tokens)}
    if cfg.family not in shape:
        return {}
    key, n = shape[cfg.family]
    draw = torch.randn((batch, n, cfg.d_model), generator=generator, device=device)
    return {key: draw.to(cfg.dtype)}


def _devices(tree) -> List[str]:
    return sorted({t.device.type for t in tree_tensors(tree)})


def run(args: argparse.Namespace, log=print) -> Dict[str, Any]:
    """Train ``args.steps`` steps (from the latest checkpoint under
    ``args.ckpt`` when there is one). Returns the per-step losses, data and
    step seconds, the data-pipeline share, and where parameters, moments
    and gradients lived."""
    import torch.distributed as dist

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = make_host_mesh(device=args.device)
    rules = default_rules(mesh)
    if dist.get_rank() != 0:
        log = lambda *a, **k: None  # noqa: E731
    model = build_model(cfg, device=args.device)

    if dist.get_rank() == 0:
        make_corpus(args.corpus)
    dist.barrier()
    shards = sorted(glob.glob(os.path.join(args.corpus, "*.gz")))
    ds = GzipCorpusDataset(
        shards,
        seq_len=args.seq,
        batch_size=args.batch * args.grad_accum,
        parallelization=args.decomp_parallelism,
        chunk_size=256 << 10,
        device=args.device,
    )
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params, opt = init_train_state(model, gen, compress_grads=args.compress_grads)
    step_fn, shardings = make_train_step(
        model, mesh, rules,
        AdamWConfig(peak_lr=args.lr, warmup_steps=max(5, args.steps // 20), total_steps=args.steps),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
    )
    opt = step_fn.place_opt_state(opt)
    shardings = dict(shardings, data={k: NamedSharding(mesh, P()) for k in ds.state_dict()})
    start_step = 0
    if args.ckpt:
        path = latest_checkpoint(args.ckpt)
        if path:
            template = {"params": params, "opt": opt, "data": ds.state_dict()}
            start_step, state = restore_checkpoint(path, template, shardings=shardings)
            opt = state["opt"]
            ds.load_state_dict(state["data"])
            log(f"[train] restored step {start_step} from {path}")

    out: Dict[str, Any] = {"arch": cfg.name, "params": cfg.param_count(),
                           "world_size": dist.get_world_size(), "backend": dist.get_backend(),
                           "start_step": start_step, "losses": [], "data_s": [], "step_s": []}
    profiled_from = args.steps - args.profile_steps if args.profile_steps else None
    prof = None
    metrics: Dict[str, Any] = {}
    t_data = t_step = 0.0
    try:
        with contextlib.ExitStack() as profiling:
            for step in range(start_step, args.steps):
                if step == profiled_from:
                    from torch.profiler import ProfilerActivity, profile

                    prof = profiling.enter_context(profile(activities=[
                        ProfilerActivity.CUDA if model.device.type == "cuda"
                        else ProfilerActivity.CPU]))
                    t_prof = time.perf_counter()
                t0 = time.perf_counter()
                batch = ds.next_batch()
                batch.update(stub_inputs(cfg, batch["tokens"].shape[0], gen, model.device))
                dt_data = time.perf_counter() - t0
                t0 = time.perf_counter()
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                dt_step = time.perf_counter() - t0
                t_data += dt_data
                t_step += dt_step
                out["losses"].append(loss)
                out["data_s"].append(dt_data)
                out["step_s"].append(dt_step)
                if step % 10 == 0 or step == args.steps - 1:
                    log(f"[train] step {step:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                        f"gnorm {float(metrics['grad_norm']):.2f}")
                if args.ckpt and (step + 1) % args.ckpt_every == 0:
                    save_checkpoint(args.ckpt, step + 1,
                                    {"params": params, "opt": opt, "data": ds.state_dict()},
                                    shardings=shardings)
                    log(f"[train] checkpoint @ step {step + 1}")
            if prof is not None:
                if model.device.type == "cuda":
                    torch.cuda.synchronize()
                wall_s = time.perf_counter() - t_prof
        if prof is not None:
            out["profile"] = _device_time(prof, wall_s, args.steps - profiled_from)
    finally:
        ds.close()

    tokens = args.steps * args.batch * args.grad_accum * args.seq
    share = t_data / max(t_data + t_step, 1e-9)
    log(f"[train] done: {tokens} tokens; data {t_data:.1f}s, step {t_step:.1f}s "
        f"(data-pipeline share {100*share:.1f}%)")
    out.update(tokens=tokens, data_share=share,
               metrics={k: float(v) for k, v in metrics.items()},
               devices={"params": _devices(params),
                        "moments": sorted(set(_devices(opt["m"])) | set(_devices(opt["v"]))),
                        "grads": sorted(step_fn.grad_devices)})
    return out


def _device_time(prof, wall_s: float, steps: int) -> Dict[str, Any]:
    """The device's busy time over the profiled steps, by kernel (CUPTI's
    "Command Buffer Full" marks a host wait, not device work)."""
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0 and e.key != "Command Buffer Full"),
                 key=lambda e: -e[1])
    busy_ms = sum(e[1] for e in ops)
    return {"steps": steps, "wall_s": wall_s, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (wall_s * 1e3) if busy_ms else None,
            "device_op_count": sum(e[2] for e in ops),
            "device_ops": [{"name": k, "ms": ms, "count": c} for k, ms, c in ops[:12]]}


def main(argv: Optional[List[str]] = None) -> None:
    import torch.distributed as dist

    try:
        run(build_parser().parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
