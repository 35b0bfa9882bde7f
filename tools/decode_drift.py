#!/usr/bin/env python3
"""Decode against the forward, by depth, for granite-3-2b at full width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/decode_drift.py --package jax --dtype bf16
    PYTHONPATH=src python3 tools/decode_drift.py --package torch --dtype fp64 --layers 8

Builds granite-3-2b at its published width with its depth cut to
``--layers``, draws the weights as the package draws them (``--seed``),
prefills one prompt of ``--prompt`` random tokens, decodes ``--steps``
tokens fed their true values, and compares each decode step's logits
with the train-mode forward of the same tokens: the largest |difference|
and the largest allclose ratio at rtol = atol = ``--tol`` (at most 1
where the bound holds). ``--package jax`` runs the JAX package (jitted, on
whatever device jax has); ``--package torch`` runs the port on
``--device``. One JSON line per run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def ratio(ref: np.ndarray, got: np.ndarray, tol: float) -> float:
    return float((np.abs(got - ref) / (tol + tol * np.abs(ref))).max())


def run_jax(args, tokens):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.distributed import default_rules
    from repro.launch.mesh import make_mesh
    from repro.models import ModelContext, build_model, transformer
    from repro.serve import prefill_to_decode_caches

    dtype = {"bf16": jnp.bfloat16, "fp32": jnp.float32, "fp64": jnp.float64}[args.dtype]
    if args.dtype == "fp64":
        jax.config.update("jax_enable_x64", True)
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=args.layers, dtype=dtype)
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = ModelContext(mesh, default_rules(mesh))
    model = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(dtype), model.init(jax.random.PRNGKey(args.seed)))
    tok = jnp.asarray(tokens, jnp.int32)
    P, S = args.prompt, tokens.shape[1]
    full = jax.jit(lambda p, t: transformer.forward(cfg, ctx, p, t, mode="train")[0])(params, tok)
    _, pc = jax.jit(lambda p, b: model.prefill(p, b, ctx))(params, {"tokens": tok[:, :P]})
    caches = prefill_to_decode_caches(cfg, model, pc, 1, S, P)
    step = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos, ctx))
    out = []
    for t in range(P, S):
        logits, caches = step(params, tok[:, t : t + 1], caches, jnp.int32(t))
        out.append((np.asarray(full[:, t], np.float64), np.asarray(logits[:, 0], np.float64)))
    return out, jax.devices()[0].device_kind


def run_torch(args, tokens):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp64": torch.float64}[args.dtype]
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=args.layers)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    model.to(dtype)
    model.cfg = cfg = dataclasses.replace(cfg, dtype=dtype)
    tok = torch.from_numpy(tokens).to(model.device)
    P, S = args.prompt, tokens.shape[1]
    with torch.inference_mode():
        full = transformer.forward(cfg, model, tok, mode="train")[0]
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=1, max_len=S)
    _, pc = prefill_fn({"tokens": tok[:, :P]})
    caches = prefill_to_decode_caches(cfg, model, pc, 1, S, P)
    out = []
    for t in range(P, S):
        _, logits, caches = decode_fn(tok[:, t : t + 1], caches, t)
        out.append((full[:, t].double().cpu().numpy(), logits[:, 0].double().cpu().numpy()))
    kind = torch.cuda.get_device_name(0) if model.device.type == "cuda" else "cpu"
    return out, kind


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--dtype", choices=("bf16", "fp32", "fp64"), default="bf16")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=40)
    ap.add_argument("--tol", type=float, default=5e-2)
    ap.add_argument("--device", default="cpu", help="the port's device (--package torch)")
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, 49155, (1, args.prompt + args.steps), dtype=np.int64)
    t0 = time.perf_counter()
    steps, kind = (run_jax if args.package == "jax" else run_torch)(args, tokens)
    print(json.dumps({
        "package": args.package, "dtype": args.dtype, "layers": args.layers,
        "prompt": args.prompt, "steps": args.steps, "seed": args.seed, "device": kind,
        "tol": args.tol, "ratio": max(ratio(f, d, args.tol) for f, d in steps),
        "max_abs_err": max(float(np.abs(d - f).max()) for f, d in steps),
        "seconds": time.perf_counter() - t0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
