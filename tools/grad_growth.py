#!/usr/bin/env python3
"""The gradient norm of granite-3-2b at full width, by depth, in both packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/grad_growth.py --layers 2 4 8

Builds granite-3-2b at its published width (d_model 2048, 32 heads, 8 KV
heads, d_ff 8192) with its depth cut to each of ``--layers`` and its
vocabulary to ``--vocab`` (so it fits a host's memory), draws the weights
with the JAX package's init (``--seed``), carries them into the port
(``params_from_jax``) and computes the loss and the global gradient norm
of one batch of ``--batch`` x ``--seq`` random tokens in each package, bf16
as the model is declared, on the CPU. One JSON line per depth, with the
JAX side's norm of each leaf's gradient.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch
    from _jax_port import jax_ctx

    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train.optimizer import global_norm

    tokens = np.random.default_rng(args.seed).integers(
        0, args.vocab, (args.batch, args.seq + 1), dtype=np.int32)
    ctx = jax_ctx()
    for n in args.layers:
        cut = dict(n_layers=n, vocab_size=args.vocab)
        jm = jax_build(dataclasses.replace(jax_config("granite-3-2b"), **cut))
        params = jm.init(jax.random.PRNGKey(args.seed))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, ctx), has_aux=True))(params, {"tokens": jnp.asarray(tokens)})
        leaf_norms = {jax.tree_util.keystr(path): float(jnp.sqrt(jnp.sum(
            jnp.square(g.astype(jnp.float32))))) for path, g in
            jax.tree_util.tree_leaves_with_path(grads)}

        cfg = dataclasses.replace(get_config("granite-3-2b"), **cut)
        model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
        del params, grads
        model.requires_grad_(True)
        tree = model.param_tree()
        t_loss, _ = model.loss({"tokens": torch.from_numpy(tokens)})
        t_grads = torch.autograd.grad(t_loss, tree_tensors(tree))
        print(json.dumps({
            "layers": n, "vocab": args.vocab, "batch": args.batch, "seq": args.seq,
            "jax": {"loss": float(loss), "grad_norm": float(np.sqrt(sum(
                v * v for v in leaf_norms.values())))},
            "torch": {"loss": float(t_loss), "grad_norm": float(global_norm(list(t_grads)))},
            "jax_leaf_grad_norms": leaf_norms,
        }), flush=True)
        del model, tree, t_grads


if __name__ == "__main__":
    main()
