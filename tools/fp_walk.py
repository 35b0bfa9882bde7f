#!/usr/bin/env python3
"""Where the port's bf16 and fp32 results part from the JAX package's, and by how much.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/fp_walk.py [--part whisper|hymba|both]

On the CPU, with the inputs of the tests it explains:

  * ``whisper``: ``tests/test_torch_families.py::test_decode_stack_modes``'s
    whisper-tiny (smoke width, the JAX init, the test's seeded frames and
    tokens), its decoder stack walked layer by layer and, inside each
    layer, op by op. Each op gets the JAX package's input on both sides,
    so a difference is the op's own. Where a bf16 product parts, the exact
    fp64 sum of the parted element is printed beside both. Then each leaf
    the test holds: both packages in fp64 (their gap), and each package's
    bf16 leaf against the JAX package's fp64 one (mean and max error).
  * ``hymba``: ``tests/test_torch_parallel.py``'s greedy decode of
    hymba-1.5b on a (2, 2) gloo mesh against one rank (``_serve_on``,
    4 ranks started by this script), in fp32 and fp64, and each fp32 run
    against the fp64 run.

Prints one line per finding; needs both packages (``jax`` and ``torch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def whisper() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_families as fam
    from _jax_port import f64, jax_fp64, strict
    from repro.models import encdec as jed
    from repro.models import layers as jl
    from repro_torch.models import encdec as ted
    from repro_torch.models import layers as tl
    from repro_torch.models.convert import params_from_jax, to_tensor

    rng = np.random.default_rng(list(b"test_decode_stack_modes"))
    jcfg, cfg, params, model = fam._whisper()
    frames, _ = fam.bf16(rng, (2, cfg.encoder_frames, cfg.d_model))
    tokens = rng.integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    tok = jnp.asarray(tokens)[:, :16]
    enc = strict(lambda p, f: jed.encode(jcfg, p, f), params, frames)
    T = lambda a: to_tensor(np.asarray(a))  # noqa: E731

    def parted(name, ref, got, exact=None):
        a, b = f64(ref), f64(got)
        diff = np.abs(a - b)
        line = "whisper %-26s parted %5d of %6d, max %.4g" % (name, (diff > 0).sum(), diff.size,
                                                           diff.max())
        if exact is not None and diff.max() > 0:
            i = np.unravel_index(np.argmax(diff), diff.shape)
            line += "; at %s: jax %r, port %r, exact %r" % (tuple(int(v) for v in i), a[i], b[i],
                                                           exact[i])
        print(line, flush=True)

    B, S = tok.shape
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    positions_t = torch.arange(S)[None].expand(B, S)
    x = strict(lambda p, t: jnp.take(p["embed"], t, axis=0) + p["pos_embed"][jnp.arange(S)][None],
               params, tok)
    for i in range(cfg.n_layers):
        p, pt = jax.tree.map(lambda a: a[i], params["decoder"]), model["decoder"][i]
        ln = lambda x, w: strict(lambda x, w: jl.layer_norm(x, w["w"], w["b"]), x, w)  # noqa: E731
        h = ln(x, p["ln1"])
        parted("L%d ln1" % i, h, tl.layer_norm(T(x), pt["ln1"]["w"], pt["ln1"]["b"]))
        a, at = p["self_attn"], pt["self_attn"]
        for w in ("wq", "wk", "wv"):
            exact = np.einsum("bsd,dhk->bshk", f64(h), f64(a[w]))
            parted("L%d self_attn %s product" % (i, w),
                   strict(lambda a, h: jnp.einsum("bsd,dhk->bshk", h, a[w]), a, h),
                   torch.einsum("bsd,dhk->bshk", T(h), at[w]), exact)
        out = strict(lambda a, h: jl.gqa_attention_block(a, h, positions, mode="train",
                                                         use_rope=False,
                                                         q_chunk=cfg.attn_q_chunk)[0], a, h)
        got, _ = ted._attn(cfg, None, at, T(h), positions_t, mode="train", cache=None,
                           cache_pos=None, q_chunk=cfg.attn_q_chunk)
        parted("L%d self_attn block" % i, out, got)
        x_mid = strict(lambda a, b: a + b, x, out)
        h2 = ln(x_mid, p["ln2"])
        k = strict(lambda c, e: jed._enc_kv(c, e)[0], p["cross_attn"], enc)
        parted("L%d cross K" % i, k, ted._enc_kv(pt["cross_attn"], T(enc))[0],
               np.einsum("btd,dhk->bthk", f64(enc), f64(p["cross_attn"]["wk"]))
               + f64(p["cross_attn"]["bk"]))
        v = strict(lambda c, e: jed._enc_kv(c, e)[1], p["cross_attn"], enc)
        cross = strict(lambda c, h, k, v: jed._cross_with_kv(c, h, k, v), p["cross_attn"], h2, k, v)
        parted("L%d cross block" % i, cross, ted._cross_with_kv(pt["cross_attn"], T(h2), T(k), T(v)))
        x_mid = strict(lambda a, b: a + b, x_mid, cross)
        h3 = ln(x_mid, p["ln3"])
        mlp = strict(lambda m, h: jed._plain_mlp(m, h), p["mlp"], h3)
        parted("L%d mlp" % i, mlp, ted._plain_mlp(pt["mlp"], T(h3)))
        x_out = strict(lambda a, b: a + b, x_mid, mlp)
        got, _ = ted.decoder_layer(cfg, pt, T(x), positions_t, T(enc), mode="train")
        parted("L%d layer (port's ops chained)" % i, x_out, got)
        x = x_out

    ref, start = fam._jax_stack(jcfg, params, jnp.asarray(tokens), enc)
    got = fam._port_stack(cfg, model, torch.from_numpy(tokens), T(enc), start)
    with jax_fp64():
        ref64, start64 = fam._jax_stack(dataclasses.replace(jcfg, dtype=jnp.float64),
                                        jax.tree.map(lambda a: jnp.asarray(f64(a)), params),
                                        jnp.asarray(tokens), jnp.asarray(f64(enc)))
    got64 = fam._port_stack(dataclasses.replace(cfg, dtype=torch.float64),
                            params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                            device="cpu").to(torch.float64),
                            torch.from_numpy(tokens), torch.from_numpy(f64(enc)), start64)
    for name in ref:
        exact = f64(ref64[name])
        e_ref, e_got = np.abs(f64(ref[name]) - exact), np.abs(f64(got[name]) - exact)
        print("whisper leaf %-10s fp64 gap %.3g | bf16 error against fp64: jax mean %.5g max "
              "%.5g, port mean %.5g max %.5g (ratios %.3f, %.3f)"
              % (name, np.abs(exact - f64(got64[name])).max(), e_ref.mean(), e_ref.max(),
                 e_got.mean(), e_got.max(), e_got.mean() / e_ref.mean(),
                 e_got.max() / e_ref.max()), flush=True)


def hymba_rank(rank: int, store: str, out: str) -> None:
    import pickle

    import torch
    import torch.distributed as dist

    import _mesh_cases as cases

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    for dtype in ("fp32", "fp64"):
        res.update(cases._serve_on("hymba-1.5b", dtype, (2, 2), cases.SERVE_PROMPT,
                                   cases.SERVE_NEW))
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


def hymba() -> None:
    import pickle

    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out.pkl")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, __file__, "--hymba-rank", str(r), store, out],
                                  env=env) for r in range(4)]
        if any(p.wait(timeout=600) for p in procs):
            raise SystemExit("a hymba rank failed")
        with open(out, "rb") as f:
            res = pickle.load(f)
    (tok1, one32), (tok4, mesh32) = res["hymba-1.5b_fp32"]
    (_, one64), (_, mesh64) = res["hymba-1.5b_fp64"]
    gap = np.abs(mesh32 - one32)
    print("hymba (2, 2) against one rank: tokens equal %s; fp32 max gap %.4g, %d of %d past "
          "1e-5 (rtol = atol); fp64 max gap %.4g"
          % (np.array_equal(tok1, tok4), gap.max(), (gap > 1e-5 + 1e-5 * np.abs(one32)).sum(),
             gap.size, np.abs(mesh64 - one64).max()))
    for name, run in (("one rank", one32), ("(2, 2)", mesh32)):
        err = np.abs(run - one64)
        print("hymba fp32 %-8s against fp64: mean %.4g, max %.4g, max by step %s"
              % (name, err.mean(), err.max(),
                 ["%.3g" % v for v in err.max(axis=(0, 2))]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--part", default="both", choices=("whisper", "hymba", "both"))
    ap.add_argument("--hymba-rank", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.hymba_rank:
        hymba_rank(int(args.hymba_rank[0]), args.hymba_rank[1], args.hymba_rank[2])
        return 0
    if args.part in ("whisper", "both"):
        whisper()
    if args.part in ("hymba", "both"):
        hymba()
    return 0


if __name__ == "__main__":
    sys.exit(main())
