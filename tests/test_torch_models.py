"""repro_torch.models against repro.models on the CPU.

Each layer on the same numpy-seeded inputs, then each of the eight decoder
configs at smoke width: both packages start from the JAX package's init
(carried over by ``params_from_jax``) and the same tokens. The JAX side is
compiled with every bf16 operation rounded (``tests/_jax_port.py``).

Tolerances (``rtol = atol``): 1e-2 for one layer's bf16 output (a few
roundings apart at most); 3e-2 on a model's bf16 logits and caches (the
JAX tests' own, ``test_moe.py``, ``test_serve_consistency.py``); 1e-2
relative on the loss. Two configs need 5e-2 on logits: deepseek-v2-236b,
where the fp32 sum of ``rms_norm`` over the 32-wide latent ``c_kv`` rounds
differently in single elements and the latent up-projections spread that
over every head (its train logits reach 1.2x the 3e-2 bound), and
hymba-1.5b, whose SSM branch adds an fp32 scan and a state reduction in
another summation order to every block (1.0x).
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_port import DECODERS, LOGIT_TOL, close, f32, jax_ctx, strict, to_torch
from repro.configs import all_configs as jax_configs
from repro.configs import smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models import layers as jl
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serve import prefill_to_decode_caches as jax_to_decode
from repro_torch.configs import all_configs, smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

LAYER_TOL = 1e-2


@pytest.fixture
def rng(request):
    return np.random.default_rng(list(request.node.name.encode()))


def bf16(rng, shape, scale=1.0):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    a = jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32)).astype(jnp.bfloat16)
    return a, to_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rms_norm(rng, dtype):
    x, xt = bf16(rng, (2, 7, 64), 3.0)
    w, wt = bf16(rng, (64,), 0.1)
    if dtype == "float32":
        x, xt = x.astype(jnp.float32), xt.float()
    out = tl.rms_norm(xt, wt)
    assert out.dtype == xt.dtype
    close(strict(jl.rms_norm, x, w), out, LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 5e5])
def test_apply_rope(rng, theta):
    x, xt = bf16(rng, (2, 9, 4, 32), 2.0)
    pos = np.broadcast_to(np.arange(100, 109)[None], (2, 9)).astype(np.int32)
    ref = strict(lambda x, p: jl.apply_rope(x, p, theta), x, jnp.asarray(pos))
    close(ref, tl.apply_rope(xt, torch.from_numpy(pos.copy()), theta), LAYER_TOL)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activations_round_as_jax(rng, name):
    x, xt = bf16(rng, (4096,), 3.0)
    ref = strict(jl.act_fn(name), x)
    assert np.array_equal(f32(ref), f32(tl.act_fn(name)(xt)))


@pytest.mark.parametrize("q_chunk,window,dv", [(None, None, 16), (16, None, 16), (16, 12, 16),
                                               (None, 12, 16), (16, None, 8)])
def test_causal_attention(rng, q_chunk, window, dv):
    """q-chunks with a static kv_hi per block, a sliding window, and the
    MLA case where the value width differs."""
    q, qt = bf16(rng, (2, 40, 4, 16))
    k, kt = bf16(rng, (2, 40, 2, 16))
    v, vt = bf16(rng, (2, 40, 2, dv))
    ref = strict(lambda q, k, v: jl.causal_attention(q, k, v, q_chunk=q_chunk,
                                                      sliding_window=window), q, k, v)
    out = tl.causal_attention(qt, kt, vt, q_chunk=q_chunk, sliding_window=window)
    assert out.shape == (2, 40, 4, dv)
    close(ref, out, LAYER_TOL)


def test_causal_attention_decode_kv_len(rng):
    q, qt = bf16(rng, (2, 1, 4, 16))
    k, kt = bf16(rng, (2, 24, 2, 16))
    v, vt = bf16(rng, (2, 24, 2, 16))
    ref = strict(lambda q, k, v, o: jl.causal_attention(
        q, k, v, q_offset=o, kv_len=jnp.full((2,), o + 1, jnp.int32)), q, k, v, jnp.int32(10))
    out = tl.causal_attention(qt, kt, vt, q_offset=10,
                              kv_len=torch.full((2,), 11, dtype=torch.int32))
    close(ref, out, LAYER_TOL)


def test_ring_attention_decode_after_wrap_around(rng):
    """20 tokens through a ring of 8 slots: outputs, slots and positions."""
    W, B = 8, 2
    cache = {"k": jnp.zeros((B, W, 2, 16), jnp.bfloat16), "v": jnp.zeros((B, W, 2, 16), jnp.bfloat16),
             "pos": jnp.full((W,), -1, jnp.int32)}
    cache_t = tl.init_kv_cache(B, W, 2, 16, ring=True)
    step = jax.jit(lambda q, c, k, v, p: jl.ring_attention_decode(q, c, k, v, p, sliding_window=W))
    for position in range(20):
        q, qt = bf16(rng, (B, 1, 4, 16))
        k, kt = bf16(rng, (B, 1, 2, 16))
        v, vt = bf16(rng, (B, 1, 2, 16))
        ref, cache = step(q, cache, k, v, jnp.int32(position))
        out, cache_t = tl.ring_attention_decode(qt, cache_t, kt, vt, position, sliding_window=W)
        close(ref, out, LAYER_TOL, "position %d" % position)
    for key in ("k", "v", "pos"):
        assert np.array_equal(f32(cache[key]), f32(cache_t[key])), key
    assert sorted(f32(cache_t["pos"]).astype(int).tolist()) == list(range(12, 20))


def _slots_by_hand(n_slots, positions, ring, first=0, n=None):
    """The position each slot of a cache holds after ``positions`` were
    written (None: empty), slots ``first`` to ``first + n`` of the whole:
    a linear cache's slot j holds position j, a ring's the last position
    written to it."""
    if ring:
        held = [None] * n_slots
        for p in positions:
            held[p % n_slots] = p
    else:
        held = list(range(n_slots))
    return held[first:first + (n or n_slots)]


def _seen_by_hand(held, q, window):
    return [p is not None and p <= q and (window is None or q - p < window) for p in held]


#: (whole slots, ring, window, this rank's first slot, its slots, positions written)
POSITION_CASES = {
    "linear": (12, False, None, 0, 12, range(12)),
    "linear_past_its_window": (12, False, 5, 0, 12, range(12)),
    "ring_with_empty_slots": (8, True, None, 0, 8, range(5)),
    "window_narrower_than_ring": (8, True, 3, 0, 8, range(20)),
    "split_linear_slice": (16, False, None, 8, 4, range(16)),
    "split_ring_slice": (8, True, 6, 4, 4, range(20)),
}


@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_position_rule_against_brute_force(case):
    """``write_kv``'s slot positions and window through ``visible``, after
    every write, against each slot's position followed by hand: seen when
    written, at or before the query and fewer than the window before it
    (a ring's window its size where none is given); a split cache's slice
    starts at ``first`` > 0, and K/V land only on the rank holding the
    slot. The train form, a query column over ``arange`` keys, as well."""
    n_whole, ring, window, first, n, written = POSITION_CASES[case]
    cache = tl.init_kv_cache(1, n, 1, 2, torch.float32, ring=ring)
    if ring:
        cache["pos"] = torch.full((n_whole,), -1, dtype=torch.int32)
    for i, q in enumerate(written):
        new = torch.full((1, 1, 1, 2), float(q + 1))
        kv_pos, w = tl.write_kv(cache, new, -new, q, window, None if n == n_whole else first)
        held = _slots_by_hand(n_whole, written[: i + 1], ring, first, n)
        expect = _seen_by_hand(held, q, window or (n_whole if ring else None))
        assert tl.visible(kv_pos, q, w).tolist() == expect, (q, kv_pos.tolist(), w)
        slot = (q % n_whole if ring else q) - first
        if 0 <= slot < n:
            assert float(cache["k"][0, slot, 0, 0]) == q + 1 == -float(cache["v"][0, slot, 0, 0])
    if not ring:
        q_pos = torch.arange(n_whole)[:, None]
        got = tl.visible(torch.arange(n_whole), q_pos, window).tolist()
        assert got == [_seen_by_hand(list(range(n_whole)), q, window) for q in range(n_whole)]


@pytest.fixture
def ssm_params(rng):
    p = jl.init_tree(jssm.ssm_defs(0, 64, 128, 8), jax.random.PRNGKey(7))
    p["a_log"] = bf16(rng, (128, 8), 0.5)[0]
    p["w_dt"] = bf16(rng, (128,), 0.5)[0]
    return p, to_torch(p)


def test_selective_ssm_at_s_300(rng, ssm_params):
    """S = 300 is not a multiple of the 256-step chunk: the second chunk is
    padded with decay 1 and drive 0, and the last state is step 299's."""
    p, pt = ssm_params
    x, xt = bf16(rng, (2, 300, 64), 0.5)
    close(strict(lambda p, x: jssm.selective_ssm(p, x)[0], p, x),
          tssm.selective_ssm(pt, xt)[0], LAYER_TOL)
    state = jssm.init_ssm_state(2, 128, 8)
    y, st = strict(lambda p, x, s: jssm.selective_ssm(p, x, state=s), p, x, state)
    yt, st_t = tssm.selective_ssm(pt, xt, state=tssm.init_ssm_state(2, 128, 8))
    close(y, yt, LAYER_TOL)
    close(st["h"], st_t["h"], LAYER_TOL)
    assert np.array_equal(f32(st["conv"]), f32(st_t["conv"]))

    # the S == 1 decode step from that state
    x1, x1t = bf16(rng, (2, 1, 64), 0.5)
    y1, st1 = strict(lambda p, x, s: jssm.selective_ssm(p, x, state=s), p, x1, st)
    y1t, st1_t = tssm.selective_ssm(pt, x1t, state=st_t)
    close(y1, y1t, LAYER_TOL)
    close(st1["h"], st1_t["h"], LAYER_TOL)
    assert np.array_equal(f32(st1["conv"]), f32(st1_t["conv"]))


def test_ssm_scan_matches_the_sequential_recurrence(rng):
    """The associative scan computes h_t = a_t h_{t-1} + b_t (fp32)."""
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 37, 3, 4)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    last, hs = tssm._ssm_scan_chunk(h0, a, b)
    h = h0
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(hs[:, t], h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last, h, rtol=1e-5, atol=1e-5)


def test_mla_prefill_and_absorbed_decode(rng):
    jcfg = jax_smoke(jax_configs()["deepseek-v2-236b"])
    cfg = smoke_config(all_configs()["deepseek-v2-236b"])
    p = jl.init_tree(jtr._attn_defs(jcfg), jax.random.PRNGKey(5))
    pt = to_torch(p)
    x, xt = bf16(rng, (2, 17, cfg.d_model))
    pos = np.broadcast_to(np.arange(17)[None], (2, 17)).astype(np.int32)
    y, cache = strict(lambda p, x, pos: jtr._mla_attention(jcfg, p, x, pos, mode="prefill"),
                      p, x, jnp.asarray(pos))
    yt, cache_t = ttr._mla_attention(cfg, pt, xt, torch.from_numpy(pos.copy()), mode="prefill")
    close(y, yt, 3e-2)
    for key in ("c_kv", "k_rope"):
        close(cache[key], cache_t[key], LAYER_TOL)

    # absorbed decode of token 16 against the first 16 tokens' cache
    padded = {k: jnp.pad(v[:, :16], ((0, 0), (0, 8), (0, 0))) for k, v in cache.items()}
    padded_t = {k: to_tensor(np.asarray(v)) for k, v in padded.items()}
    y_dec, cache_dec = strict(
        lambda p, x, pos, c: jtr._mla_attention(jcfg, p, x, pos, mode="decode", cache=c,
                                                cache_pos=jnp.int32(16)),
        p, x[:, 16:17], jnp.asarray(pos[:, 16:17]), padded)
    y_dec_t, cache_dec_t = ttr._mla_attention(cfg, pt, xt[:, 16:17],
                                              torch.from_numpy(pos[:, 16:17].copy()),
                                              mode="decode", cache=padded_t, cache_pos=16)
    close(y_dec, y_dec_t, 3e-2)
    for key in ("c_kv", "k_rope"):
        close(cache_dec[key], cache_dec_t[key], LAYER_TOL)


def test_mla_absorbed_decode_exact_in_fp32(rng):
    """In fp32 the absorbed decode equals the expanded attention (1e-4), as
    the JAX package's test_mla_absorbed_exact_fp32 holds its own."""
    cfg = dataclasses.replace(smoke_config(all_configs()["deepseek-v2-236b"]), dtype=torch.float32)
    p = {k: v.float() for k, v in to_torch(jl.init_tree(
        jtr._attn_defs(jax_smoke(jax_configs()["deepseek-v2-236b"])), jax.random.PRNGKey(0))).items()}
    S = 17
    x = torch.from_numpy((rng.normal(size=(2, S, cfg.d_model)) * 0.3).astype(np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    y_full, cache = ttr._mla_attention(cfg, p, x, pos, mode="prefill")
    prefix = {k: torch.nn.functional.pad(v[:, : S - 1], (0, 0, 0, 4)) for k, v in cache.items()}
    y_dec, _ = ttr._mla_attention(cfg, p, x[:, S - 1 :], pos[:, S - 1 :], mode="decode",
                                  cache=prefix, cache_pos=S - 1)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, S - 1], rtol=1e-4, atol=1e-4)


def _dropped_pairs(x, router, top_k, cf):
    """Pairs past the second dispatch's capacity, counted in numpy from the
    routing: token-major pairs, each expert's slots in pair order."""
    T = x.shape[0] * x.shape[1]
    logits = f32(x).reshape(T, -1) @ f32(router)
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :top_k].reshape(-1)
    n_exp = router.shape[-1]
    cap1 = max(8, math.ceil(T * top_k * cf))
    cap2 = max(8, math.ceil(cap1 / n_exp * cf))
    counts = np.zeros(n_exp, int)
    dropped = 0
    for e in idx[:cap1]:
        dropped += counts[e] >= cap2
        counts[e] += 1
    return dropped


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_layer(rng, cf):
    """Dropless at 8.0; at 1.0 the second dispatch's capacity,
    max(8, ceil(ceil(T k cf) / E cf)) = 16 slots an expert, drops pairs."""
    p = jl.init_tree(jmoe.moe_defs(0, 64, 8, 32, 0), jax.random.PRNGKey(9))
    x, xt = bf16(rng, (2, 32, 64))
    ctx = jax_ctx()
    y, aux = strict(lambda p, x: jmoe.moe_layer(p, x, mesh=ctx.mesh, top_k=2,
                                                 capacity_factor=cf), p, x)
    yt, aux_t = tmoe.moe_layer(to_torch(p), xt, top_k=2, capacity_factor=cf)
    close(y, yt, LAYER_TOL)
    assert float(aux_t) == pytest.approx(float(aux), rel=1e-5)
    dropped = _dropped_pairs(x, p["router"], 2, cf)
    assert (dropped > 0) == (cf == 1.0), dropped


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_masks_negative_labels(rng, z_loss):
    logits, logits_t = bf16(rng, (2, 7, 50), 3.0)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = -1
    loss, metrics = strict(lambda l, y: jmodel.cross_entropy(l, y, z_loss=z_loss), logits,
                           jnp.asarray(labels))
    loss_t, metrics_t = tmodel.cross_entropy(logits_t, torch.from_numpy(labels), z_loss=z_loss)
    assert float(loss_t) == pytest.approx(float(loss), rel=1e-5)
    assert sorted(metrics_t) == sorted(metrics)
    for key in metrics:
        assert float(metrics_t[key]) == pytest.approx(float(metrics[key]), rel=1e-5)
    assert float(metrics_t["tokens"]) == 10


# ---------------------------------------------------------------------------
# the eight decoder configs at smoke width
# ---------------------------------------------------------------------------

B, PROMPT, TOTAL = 2, 24, 28
_runs = {}


def _run(arch):
    """Both packages on one config: train logits, loss, prefill logits and
    caches, and three decode steps."""
    if arch in _runs:
        return _runs[arch]
    jcfg = jax_smoke(jax_configs()[arch])
    cfg = smoke_config(all_configs()[arch])
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    ctx = jax_ctx()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, TOTAL + 1), dtype=np.int32)
    extra, extra_t = {}, {}
    if cfg.family == "vlm":
        patches = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        extra["patches"] = jnp.asarray(patches).astype(jnp.bfloat16)
        extra_t["patches"] = to_tensor(np.asarray(extra["patches"]))
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    max_len = TOTAL + prefix + 4
    tok = jnp.asarray(tokens)
    tok_t = torch.from_numpy(tokens)
    out = {"cfg": cfg, "model": model}

    out["train"] = (
        strict(lambda p, t, e: jtr.forward(jcfg, ctx, p, t, mode="train",
                                           prefix_embeds=e.get("patches"))[0],
               params, tok[:, :TOTAL], extra),
        ttr.forward(cfg, model, tok_t[:, :TOTAL], mode="train",
                    prefix_embeds=extra_t.get("patches"))[0])
    out["loss"] = (strict(lambda p, b: jm.loss(p, b, ctx), params, {"tokens": tok, **extra}),
                   model.loss({"tokens": tok_t, **extra_t}))
    jlogits, jcaches = strict(lambda p, b: jm.prefill(p, b, ctx), params,
                              {"tokens": tok[:, :PROMPT], **extra})
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)
    logits, caches = prefill_fn({"tokens": tok_t[:, :PROMPT], **extra_t})
    out["prefill"] = (jlogits, logits)
    out["prefill_caches"] = (jcaches, caches)
    jc = jax_to_decode(jcfg, jm, jcaches, B, max_len, PROMPT + prefix)
    tc = prefill_to_decode_caches(cfg, model, caches, B, max_len, PROMPT + prefix)
    steps = []
    for t in range(PROMPT, PROMPT + 3):
        jl_d, jc = strict(lambda p, x, c, pos: jm.decode_step(p, x, c, pos, ctx), params,
                          tok[:, t : t + 1], jc, jnp.int32(t + prefix))
        _, tl_d, tc = decode_fn(tok_t[:, t : t + 1], tc, t + prefix)
        steps.append((jl_d, tl_d))
    out["decode"] = steps
    _runs[arch] = out
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_train_logits(arch):
    ref, got = _run(arch)["train"]
    assert got.shape == ref.shape
    close(ref, got, LOGIT_TOL[arch])


@pytest.mark.parametrize("arch", DECODERS)
def test_loss(arch):
    (ref, metrics), (got, metrics_t) = _run(arch)["loss"]
    assert float(got) == pytest.approx(float(ref), rel=1e-2)
    assert sorted(metrics_t) == sorted(metrics)
    assert float(metrics_t["nll"]) == pytest.approx(float(metrics["nll"]), rel=1e-2)
    assert float(metrics_t["aux_loss"]) == pytest.approx(float(metrics["aux_loss"]), rel=1e-2,
                                                         abs=1e-6)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_logits(arch):
    ref, got = _run(arch)["prefill"]
    assert got.shape == ref.shape == (B, 1, _run(arch)["cfg"].vocab_size)
    close(ref, got, LOGIT_TOL[arch])


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_caches(arch):
    ref, got = _run(arch)["prefill_caches"]
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert leaves
    for path, leaf in leaves:
        node = got
        for key in path:
            node = node[key.key]
        name = "/".join(key.key for key in path)
        assert tuple(node.shape) == leaf.shape, name
        close(leaf, node, LOGIT_TOL[arch], name)


@pytest.mark.parametrize("arch", DECODERS)
def test_three_decode_steps(arch):
    for step, (ref, got) in enumerate(_run(arch)["decode"]):
        close(ref, got, LOGIT_TOL[arch], "decode step %d" % step)


#: Each attention path, and how many times a call of it reaches the core:
#: (arch, path, calls). Smoke width: 2 decoder layers (3 for the MLA
#: config), 2 encoder layers; a prompt of 80 is two q-blocks of 64.
CORE_PATHS = {
    "train": ("granite-3-2b", "train", 2),
    "prefill_in_two_q_blocks": ("granite-3-2b", "prefill", 4),
    "linear_decode": ("granite-3-2b", "decode", 2),
    "ring_decode_past_wrap_around": ("hymba-1.5b", "decode", 2),
    "mla_decode": ("deepseek-v2-lite", "decode", 3),
    "encoder_unmasked": ("whisper-tiny", "encode", 2),
}


@pytest.mark.parametrize("case", list(CORE_PATHS))
def test_every_attention_goes_through_the_core(monkeypatch, case):
    """Every attention layer reaches ``layers.attend`` once per call of the
    path (once per q-block where a prefill chunks): a train forward, a
    chunked prefill, a linear decode step, a ring decode step past
    wrap-around (hymba's 64-slot ring at position 80), an MLA decode step
    (DeepSeek-V2-Lite at smoke width: no query LoRA, YaRN) and the
    encoder's unmasked attention. Each passes its scores as a temporary
    (as many references as a temporary passed here), so the core frees
    the unmasked scores once masked."""
    from repro_torch.configs.deepseek_v2_lite import CONFIG as LITE
    from repro_torch.models import encdec as tencdec

    arch, path, expected = CORE_PATHS[case]
    cfg = (dataclasses.replace(smoke_config(LITE), q_lora_rank=0) if arch == LITE.name
           else smoke_config(all_configs()[arch]))
    model = tmodel.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 81)))
    calls = []
    core = tl.attend

    def counted(*args, **kw):
        calls.append(sys.getrefcount(args[0]))
        return core(*args, **kw)

    counted(torch.zeros(1, 1, 1, 1, 2) + 0, None, torch.zeros(1, 2, 1, 1))
    temporary = calls.pop()
    for module in (tl, ttr):
        monkeypatch.setattr(module, "attend", counted)
    with torch.inference_mode():
        if path == "train":
            model.logits({"tokens": tokens[:, :28]})
        elif path == "prefill":
            model.prefill({"tokens": tokens[:, :80]})
        elif path == "encode":
            frames = torch.zeros((2, cfg.encoder_frames, cfg.d_model), dtype=cfg.dtype)
            tencdec.encode(cfg, model, frames)
        else:
            prefill_fn, decode_fn, _ = make_serve_steps(model, batch=2, max_len=96)
            _, caches = prefill_fn({"tokens": tokens[:, :80]})
            caches = prefill_to_decode_caches(cfg, model, caches, 2, 96, 80)
            calls.clear()
            decode_fn(tokens[:, 80:81], caches, 80)
            if arch == "hymba-1.5b":
                pos = caches["layers"]["attn"]["pos"][0]
                assert pos.shape == (64,) and int(pos[80 % 64]) == 80 and int(pos.min()) == 17
    assert calls == [temporary] * expected, (calls, temporary)


def test_model_init_draws_the_declared_distributions():
    """init draws normal x 1/sqrt(fan_in) (fan_in = shape[-2]) or x scale,
    zeros and ones, bf16 unless declared fp32 (the MoE router)."""
    cfg = dataclasses.replace(smoke_config(all_configs()["deepseek-moe-16b"]), vocab_size=4096)
    model = tmodel.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    embed = model["embed"].float()
    assert embed.std().item() == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    w_up = torch.stack([layer["moe"]["w_up"] for layer in model["moe_layers"]]).float()
    assert w_up.std().item() == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    assert model["moe_layers"][0]["moe"]["router"].dtype == torch.float32
    assert model["moe_layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert not model["final_norm"].any()
    assert not model["dense_layers"][0]["norm1"].any()
    layers = model["moe_layers"]
    assert not torch.equal(layers[0]["attn"]["wq"], layers[1]["attn"]["wq"])
