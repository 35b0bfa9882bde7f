"""repro_torch.serve: prefill plus token-by-token decode against the full
forward (the port alone, mirroring test_serve_consistency.py), the cache
layout against the JAX package's, the serve steps against a greedy run of
the JAX package's own serve steps, and the serving example on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_port import DECODERS, LOGIT_TOL, close, f32, jax_ctx, to_torch
from repro.configs import all_configs as jax_configs
from repro.configs import smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.serve import make_serve_steps as jax_serve_steps
from repro.serve import prefill_to_decode_caches as jax_to_decode
from repro_torch.configs import all_configs, smoke_config
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

ROOT = Path(__file__).resolve().parents[1]


def _model(arch, seed):
    cfg = smoke_config(all_configs()[arch])
    return cfg, build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """As test_serve_consistency.py: 2e-2, but 3e-1 for MLA, whose absorbed
    decode reassociates bf16 products, (q W_uk) c_kv against q (W_uk c_kv).
    The JAX test's 1.5e-1 holds for its seeds; with every bf16 product
    rounded as written (the port, and the JAX package compiled so), six
    seeds of this model reached 0.3-2.2x of it, a handful of 1024 logits
    each up to 0.3 apart. test_torch_models.py holds the absorbed form
    exact in fp32."""
    cfg, model = _model(arch, 3)
    gen = torch.Generator().manual_seed(4)
    B, S_pre, S_total = 2, 24, 30
    tokens = torch.randint(0, cfg.vocab_size, (B, S_total), generator=gen)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(B, cfg.vision_tokens, cfg.d_model,
                                       generator=gen).bfloat16()
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    full = transformer.forward(cfg, model, tokens, mode="train",
                               prefix_embeds=extra.get("patches"))[0][:, prefix:]
    max_len = S_total + prefix + 4
    prefill_fn, decode_fn, abstract = make_serve_steps(model, batch=B, max_len=max_len)
    logits_pre, pc = prefill_fn({"tokens": tokens[:, :S_pre], **extra})
    close(full[:, S_pre - 1], logits_pre[:, 0], 2e-2)
    caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, S_pre + prefix)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), caches) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), abstract)
    tol = 3e-1 if cfg.use_mla else 2e-2
    for t in range(S_pre, S_total):
        nxt, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t + prefix)
        close(full[:, t], logits_d[:, 0], tol, "%s decode step %d" % (arch, t))
        assert torch.equal(nxt[:, 0], logits_d[:, -1].argmax(-1).to(torch.int32))


def test_hymba_ring_cache_decode():
    """A prompt longer than the 64-token window: the ring holds the last 64
    positions, and decode matches the full forward (3e-2, as the JAX
    test)."""
    cfg, model = _model("hymba-1.5b", 4)
    B, S_pre, S_total = 1, 80, 96
    tokens = torch.randint(0, cfg.vocab_size, (B, S_total), generator=torch.Generator().manual_seed(5))
    full = transformer.forward(cfg, model, tokens, mode="train")[0]
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=S_total + 4)
    logits_pre, pc = prefill_fn({"tokens": tokens[:, :S_pre]})
    close(full[:, S_pre - 1], logits_pre[:, 0], 3e-2)
    caches = prefill_to_decode_caches(cfg, model, pc, B, S_total + 4, S_pre)
    assert caches["layers"]["attn"]["k"].shape[2] == cfg.sliding_window
    for t in range(S_pre, S_total):
        _, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t)
        close(full[:, t], logits_d[:, 0], 3e-2, "hymba ring decode step %d" % t)


@pytest.mark.parametrize("arch,prompt", [("granite-3-2b", 24), ("deepseek-v2-236b", 24),
                                         ("hymba-1.5b", 80), ("hymba-1.5b", 24),
                                         ("internvl2-76b", 24)])
def test_prefill_to_decode_caches_matches_jax(arch, prompt):
    """The same prefill caches laid out by both packages: equal bit for bit,
    ring slots and positions included (hymba at 80 > its 64-token
    window)."""
    jcfg = jax_smoke(jax_configs()[arch])
    cfg = smoke_config(all_configs()[arch])
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    B = 2
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, prompt), dtype=np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    if prefix:
        batch["patches"] = jnp.zeros((B, prefix, cfg.d_model), jnp.bfloat16)
    _, jcaches = jax.jit(lambda p, b: jm.prefill(p, b, jax_ctx()))(params, batch)
    max_len = prompt + prefix + 8
    ref = jax_to_decode(jcfg, jm, jcaches, B, max_len, prompt + prefix)
    got = prefill_to_decode_caches(cfg, build_model(cfg, device="cpu"), to_torch(jcaches), B,
                                   max_len, prompt + prefix)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in leaves:
        node = got
        for key in path:
            node = node[key.key]
        name = "/".join(key.key for key in path)
        assert node.dtype == to_tensor(np.asarray(leaf)).dtype, name
        assert np.array_equal(f32(leaf), f32(node)), name
    if arch == "hymba-1.5b" and prompt > cfg.sliding_window:
        pos = f32(got["layers"]["attn"]["pos"][0]).astype(int)
        assert sorted(pos.tolist()) == list(range(prompt - cfg.sliding_window, prompt))


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b", "hymba-1.5b",
                                  "internvl2-76b"])
def test_serve_steps_follow_a_jax_greedy_run(arch):
    """The JAX package's serve steps generate greedily; the port's steps,
    fed the same tokens, give the same logits at every step and pick the
    same next tokens."""
    jcfg = jax_smoke(jax_configs()[arch])
    cfg = smoke_config(all_configs()[arch])
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(6))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    ctx = jax_ctx()
    B, P, N = 2, 16, 5
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_len = P + N + prefix
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens)}
    if prefix:
        patches = rng.normal(size=(B, prefix, cfg.d_model)).astype(np.float32)
        batch["patches"] = jnp.asarray(patches).astype(jnp.bfloat16)
        batch_t["patches"] = to_tensor(np.asarray(batch["patches"]))

    options = {"xla_allow_excess_precision": False}
    j_prefill, j_decode, _, _ = jax_serve_steps(jm, ctx.mesh, ctx.rules, batch=B, max_len=max_len)
    j_prefill = j_prefill.lower(params, batch).compile(compiler_options=options)
    jlogits, jpc = j_prefill(params, batch)
    jc = jax_to_decode(jcfg, jm, jpc, B, max_len, P + prefix)
    jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    j_decode = j_decode.lower(params, jtok, jc, jnp.int32(0)).compile(compiler_options=options)

    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)
    logits, pc = prefill_fn(batch_t)
    close(jlogits, logits, LOGIT_TOL[arch], "prefill")
    caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, P + prefix)
    for t in range(N - 1):
        jnext, jlogits_d, jc = j_decode(params, jtok, jc, jnp.int32(P + prefix + t))
        nxt, logits_d, caches = decode_fn(torch.from_numpy(np.array(jtok)), caches,
                                          P + prefix + t)
        close(jlogits_d, logits_d, LOGIT_TOL[arch], "decode step %d" % t)
        assert np.array_equal(np.asarray(jnext), nxt.numpy()), "decode step %d" % t
        jtok = jnext


@pytest.mark.parametrize("corpus", [False, True])
def test_example_runs_on_the_cpu(corpus, tmp_path):
    args = [sys.executable, str(ROOT / "examples" / "serve_batched_torch.py"), "--device", "cpu",
            "--new-tokens", "4"]
    args += ["--corpus-mb", "0.05", "--corpus-shards", "2"] if corpus else ["--no-corpus"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    proc = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "prefill 4x32" in proc.stdout and "decode 3 steps" in proc.stdout
    assert proc.stdout.count("  seq ") == 4
    if corpus:
        assert "corpus service: 6 kB of context served" in proc.stdout
        assert "fallbacks replace=0 crc=0" in proc.stdout
