"""The xLSTM and Whisper families of repro_torch against repro on the CPU.

Each xLSTM form (parallel, chunkwise with padding, the recurrent step, the
sLSTM scan) and each block on the same numpy-seeded inputs; the Whisper
encoder, decoder stack (train, prefill, decode) and cross attention; then
xlstm-350m and whisper-tiny at smoke width from the JAX init (carried over
by ``params_from_jax``): loss, prefill and decode logits, and the caches.
The JAX side is compiled with every bf16 operation rounded
(``tests/_jax_port.py``).

Tolerances (``rtol = atol``): 1e-2 for one block's bf16 output, 3e-2 on a
model's bf16 logits and caches (the JAX tests' own), 1e-2 relative on the
loss; fp32 states and gates of a form 1e-4, fp32 forms against each other
1e-4 (the JAX test holds bf16 forms to 3e-2 and 4e-2).

Whisper's decoder stack and its caches are held another way. Both packages
round to bf16 after the same operations, but a bf16 product's fp32 sum is
taken in the library's order: on some hosts one output of the first
self-attention's ``wq`` product rounds to the other side of a tie
(6.1875 against 6.21875, exactly 6.2031246), and near-hard attention
carries that to 0.137 in the logits (1.46 % of them past 3e-2). So each
leaf is computed by both packages in fp64 from the same weights and
inputs (``_jax_port.jax_fp64``), which must agree within 1e-9 (the same
arithmetic; measured 1.4e-12), and each bf16 leaf's mean and max error
against the JAX package's fp64 leaf may be at most ``NO_WORSE`` (1.25)
times the JAX package's own bf16 leaf's (measured 1.000-1.024 on the
decoder stack's leaves). ``tools/fp_walk.py`` prints the walk and these
figures.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_port import close, close64, f32, f64, jax_ctx, jax_fp64, no_worse, strict, to_torch
from repro.configs import all_configs as jax_configs
from repro.configs import smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models import encdec as jed
from repro.models import layers as jl
from repro.models import xlstm as jx
from repro.serve import prefill_to_decode_caches as jax_to_decode
from repro_torch.configs import all_configs, smoke_config
from repro_torch.models import EncDecModel, XLSTMModel, build_model
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tl
from repro_torch.models import xlstm as tx
from repro_torch.models.convert import params_from_jax, params_to_jax, to_tensor
from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

LAYER_TOL = 1e-2
MODEL_TOL = 3e-2
FAMILIES = ["xlstm-350m", "whisper-tiny"]


@pytest.fixture
def rng(request):
    return np.random.default_rng(list(request.node.name.encode()))


def bf16(rng, shape, scale=1.0):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    a = jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32)).astype(jnp.bfloat16)
    return a, to_tensor(np.asarray(a))


def fp32(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm(rng, dtype):
    x, xt = bf16(rng, (2, 7, 64), 3.0)
    w, wt = bf16(rng, (64,), 1.0)
    b, bt = bf16(rng, (64,), 0.5)
    if dtype == "float32":
        x, xt = x.astype(jnp.float32) + 5, xt.float() + 5
    out = tl.layer_norm(xt, wt, bt)
    assert out.dtype == xt.dtype
    close(strict(jl.layer_norm, x, w, b), out, LAYER_TOL if dtype == "bfloat16" else 1e-5)


def test_cross_attention_block(rng):
    p = to_torch(jl.init_tree(jl.gqa_defs(64, 4, 2, 16), jax.random.PRNGKey(1)))
    jp = jl.init_tree(jl.gqa_defs(64, 4, 2, 16), jax.random.PRNGKey(1))
    x, xt = bf16(rng, (2, 9, 64))
    enc, enc_t = bf16(rng, (2, 21, 64))
    out = tl.cross_attention_block(p, xt, enc_t)
    assert out.shape == (2, 9, 64)
    close(strict(jl.cross_attention_block, jp, x, enc), out, LAYER_TOL)


# ---------------------------------------------------------------------------
# xLSTM forms and blocks
# ---------------------------------------------------------------------------

def _gates(rng, shape):
    log_i, log_i_t = fp32(rng, shape, 2.0)
    f_raw, _ = fp32(rng, shape, 2.0)
    log_f = jax.nn.log_sigmoid(f_raw + 3)
    return (log_i, log_f), (log_i_t, torch.from_numpy(np.asarray(log_f)))


@pytest.mark.parametrize("s", [1, 37, 64])
def test_mlstm_parallel_form(rng, s):
    q, qt = bf16(rng, (2, s, 4, 16))
    k, kt = bf16(rng, (2, s, 4, 16))
    v, vt = bf16(rng, (2, s, 4, 16))
    (li, lf), (li_t, lf_t) = _gates(rng, (2, s, 4))
    out = tx._mlstm_parallel(qt, kt, vt, li_t, lf_t)
    assert out.dtype == torch.bfloat16
    close(strict(jx._mlstm_parallel, q, k, v, li, lf), out, LAYER_TOL)


@pytest.mark.parametrize("s,chunk,with_state", [(64, 16, False), (50, 16, False), (50, 16, True),
                                                (300, 256, False)])
def test_mlstm_chunkwise_form(rng, s, chunk, with_state):
    """Padding (50 and 300 are not multiples of the chunk: log_i -1e30,
    log_f 0) and a carried-in state; outputs and the fp32 state."""
    q, qt = bf16(rng, (2, s, 4, 16))
    k, kt = bf16(rng, (2, s, 4, 16))
    v, vt = bf16(rng, (2, s, 4, 16))
    (li, lf), (li_t, lf_t) = _gates(rng, (2, s, 4))
    state = state_t = None
    if with_state:
        c, c_t = fp32(rng, (2, 4, 16, 16), 0.1)
        n, n_t = fp32(rng, (2, 4, 16), 0.1)
        m, m_t = fp32(rng, (2, 4), 0.5)
        state, state_t = {"c": c, "n": n, "m": m}, {"c": c_t, "n": n_t, "m": m_t}
    h, st = strict(lambda *a: jx._mlstm_chunkwise(*a, chunk=chunk, init_state=state),
                   q, k, v, li, lf)
    ht, st_t = tx._mlstm_chunkwise(qt, kt, vt, li_t, lf_t, chunk=chunk, init_state=state_t)
    assert ht.shape == (2, s, 4, 16)
    close(h, ht, LAYER_TOL)
    for key in ("c", "n", "m"):
        assert st_t[key].dtype == torch.float32
        close(st[key], st_t[key], 1e-4, key)


def test_mlstm_recurrent_step(rng):
    q, qt = bf16(rng, (2, 4, 16))
    k, kt = bf16(rng, (2, 4, 16))
    v, vt = bf16(rng, (2, 4, 16))
    (li, lf), (li_t, lf_t) = _gates(rng, (2, 4))
    for start in ("empty", "carried"):
        if start == "empty":
            state = jx.init_mlstm_state(2, 32, 4)
            state_t = tx.init_mlstm_state(2, 32, 4)
        else:
            state = {"c": jnp.asarray(f32(st["c"])), "n": jnp.asarray(f32(st["n"])),
                     "m": jnp.asarray(f32(st["m"]))}
            state_t = st_t
        st, h = strict(jx._mlstm_recurrent_step, state, q, k, v, li, lf)
        st_t, ht = tx._mlstm_recurrent_step(state_t, qt, kt, vt, li_t, lf_t)
        close(h, ht, LAYER_TOL, start)
        for key in ("c", "n", "m"):
            close(st[key], st_t[key], 1e-4, "%s %s" % (start, key))


def test_init_states_match_jax():
    m, m_t = jx.init_mlstm_state(3, 32, 4), tx.init_mlstm_state(3, 32, 4)
    for key in ("c", "n", "m"):
        assert np.array_equal(np.asarray(m[key]), m_t[key].numpy()), key
    assert float(m_t["m"][0, 0]) == float(np.float32(-1e30))
    s, s_t = jx.init_slstm_state(3, 32, 4), tx.init_slstm_state(3, 32, 4)
    assert isinstance(s_t, tuple) and len(s_t) == 4
    for a, b in zip(s, s_t):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert len({t.data_ptr() for t in s_t}) == 4  # decode writes each in place


def _block_params(kind, seed):
    defs = (jx.mlstm_defs if kind == "mlstm" else jx.slstm_defs)(0, 64, 4)
    p = jl.init_tree(defs, jax.random.PRNGKey(seed))
    # norms drawn away from zero so they weigh in
    rng = np.random.default_rng(seed)
    for key in ("norm", "out_norm"):
        p[key] = jnp.asarray(rng.normal(size=p[key].shape) * 0.2).astype(jnp.bfloat16)
    return p, to_torch(p)


@pytest.mark.parametrize("s,mode", [(40, "train"), (40, "prefill"), (300, "train"),
                                    (1, "decode")])
def test_mlstm_block(rng, s, mode):
    """train: the parallel form (S <= 256) or the chunkwise one (300);
    prefill: the chunkwise form with its state; decode: the recurrent
    step from a state."""
    p, pt = _block_params("mlstm", 2)
    x, xt = bf16(rng, (2, s, 64), 0.5)
    state = state_t = None
    if mode == "decode":
        prefix, prefix_t = bf16(rng, (2, 9, 64), 0.5)
        _, state = strict(lambda p, x: jx.mlstm_block(p, x, 4, return_state=True), p, prefix)
        _, state_t = tx.mlstm_block(pt, prefix_t, 4, return_state=True)
    keep = mode == "prefill"
    y, st = strict(lambda p, x, s: jx.mlstm_block(p, x, 4, state=s, return_state=keep),
                   p, x, state)
    yt, st_t = tx.mlstm_block(pt, xt, 4, state=state_t, return_state=keep)
    close(y, yt, LAYER_TOL)
    assert (st is None) == (st_t is None) == (mode == "train")
    if st is not None:
        for key in ("c", "n", "m"):
            close(st[key], st_t[key], 1e-3, key)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block(rng, with_state):
    p, pt = _block_params("slstm", 3)
    x, xt = bf16(rng, (2, 23, 64), 0.5)
    state = state_t = None
    if with_state:
        parts = [fp32(rng, (2, 4, 16), 0.3) for _ in range(4)]
        state, state_t = tuple(a for a, _ in parts), tuple(b for _, b in parts)
    y, st = strict(lambda p, x, s: jx.slstm_block(p, x, 4, state=s, return_state=True),
                   p, x, state)
    yt, st_t = tx.slstm_block(pt, xt, 4, state=state_t, return_state=True)
    close(y, yt, LAYER_TOL)
    for i, (a, b) in enumerate(zip(st, st_t)):
        close(a, b, 1e-3, "carry %d" % i)


def test_xlstm_forms_consistent():
    """test_serve_consistency.py::test_xlstm_forms_consistent on the port,
    in fp32: the parallel form equals the chunkwise one, the recurrent step
    from the chunkwise state equals the parallel form over S + 1 (1e-4;
    the JAX test holds bf16 to 3e-2 and 4e-2), and the model's decode after
    a prefill equals the prefill of the longer prefix."""
    gen = torch.Generator().manual_seed(5)
    B, S, D, H = 2, 64, 64, 4
    p = tl.ParamTree(tx.mlstm_defs(0, D, H), "cpu")
    p.assign(tx.mlstm_defs(0, D, H), lambda d, path: d.initialize(gen, "cpu"))
    p.float()
    x = torch.randn((B, S, D), generator=gen) * 0.3
    out_par, _ = tx.mlstm_block(p, x, H)
    out_chunk, st = tx.mlstm_block(p, x, H, return_state=True)
    torch.testing.assert_close(out_par, out_chunk, rtol=1e-4, atol=1e-4)
    x1 = torch.randn((B, 1, D), generator=gen) * 0.3
    out_rec, _ = tx.mlstm_block(p, x1, H, state=st)
    full2, _ = tx.mlstm_block(p, torch.cat([x, x1], 1), H)
    torch.testing.assert_close(out_rec[:, 0], full2[:, -1], rtol=1e-4, atol=1e-4)

    cfg = smoke_config(all_configs()["xlstm-350m"])
    model = build_model(cfg, device="cpu").init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    _, caches = model.prefill({"tokens": tokens[:, :32]})
    logits_d, _ = model.decode_step(tokens[:, 32:33], caches, 32)
    logits_ref33, _ = model.prefill({"tokens": tokens[:, :33]})
    close(logits_ref33[:, -1], logits_d[:, 0], 4e-2)


# ---------------------------------------------------------------------------
# the Whisper backbone
# ---------------------------------------------------------------------------

def _whisper(seed=3):
    jcfg = jax_smoke(jax_configs()["whisper-tiny"])
    cfg = smoke_config(all_configs()["whisper-tiny"])
    params = jax_build(jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")


def test_sinusoids_match_jax():
    assert np.array_equal(ted._sinusoids(1500, 384), jed._sinusoids(1500, 384))


def test_encode(rng):
    jcfg, cfg, params, model = _whisper()
    frames, frames_t = bf16(rng, (2, cfg.encoder_frames, cfg.d_model))
    close(strict(lambda p, f: jed.encode(jcfg, p, f), params, frames),
          ted.encode(cfg, model, frames_t), MODEL_TOL)


def _jax_stack(jcfg, params, tok, enc):
    """The JAX package's decoder stack: train and prefill logits, the
    prefill caches, then three decode steps from them; and the decode
    caches it started from."""
    out = {}
    for mode in ("train", "prefill"):
        out[mode], caches = strict(lambda p, t, e: jed.decode_stack(jcfg, p, t, e, mode=mode),
                                   params, tok[:, :16], enc)
    assert sorted(caches) == ["attn", "cross_k", "cross_v"]
    out.update(cross_k=caches["cross_k"], cross_v=caches["cross_v"], **caches["attn"])
    jc = jax.tree.map(lambda d, s: d.at[:, :, : s.shape[2]].set(s) if d.ndim == 5 and
                      d.shape[2] != s.shape[2] else s,
                      jed.init_decoder_caches(jcfg, 2, 24, enc.shape[1]), caches)
    start = jax.tree.map(np.asarray, jc)
    for t in range(16, 19):
        out["decode %d" % t], jc = strict(lambda p, x, c, pos: jed.decode_stack(
            jcfg, p, x, None, mode="decode", caches=c, cache_pos=pos),
            params, tok[:, t : t + 1], jc, jnp.int32(t))
    out["decode k"] = jc["attn"]["k"]
    return out, start


def _port_stack(cfg, model, tok_t, enc_t, start):
    """The port's stack on the same inputs, decoding from ``start``."""
    out = {}
    for mode in ("train", "prefill"):
        out[mode], caches = ted.decode_stack(cfg, model, tok_t[:, :16], enc_t, mode=mode)
    assert sorted(caches) == ["attn", "cross_k", "cross_v"]
    out.update(cross_k=caches["cross_k"], cross_v=caches["cross_v"], **caches["attn"])
    tc = jax.tree.map(lambda a: to_tensor(a).clone(), start)
    for t in range(16, 19):
        out["decode %d" % t], tc_out = ted.decode_stack(
            cfg, model, tok_t[:, t : t + 1], None, mode="decode", caches=tc, cache_pos=t)
        assert tc_out is tc
    out["decode k"] = tc["attn"]["k"]
    return out


def test_decode_stack_modes(rng):
    """train and prefill logits, the prefill caches (self K/V, cross K/V),
    then three decode steps from the same caches and the K cache they
    wrote: both packages in fp64 from the same weights and inputs within
    1e-9 (the same arithmetic), and each bf16 leaf no further from the JAX
    package's fp64 leaf than ``NO_WORSE`` times the JAX package's own bf16
    leaf, in mean and max error (module docstring)."""
    jcfg, cfg, params, model = _whisper()
    frames, frames_t = bf16(rng, (2, cfg.encoder_frames, cfg.d_model))
    tokens = rng.integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    tok, tok_t = jnp.asarray(tokens), torch.from_numpy(tokens)
    enc = strict(lambda p, f: jed.encode(jcfg, p, f), params, frames)
    ref, start = _jax_stack(jcfg, params, tok, enc)
    got = _port_stack(cfg, model, tok_t, to_tensor(np.asarray(enc)), start)
    with jax_fp64():
        ref64, start64 = _jax_stack(dataclasses.replace(jcfg, dtype=jnp.float64),
                                    jax.tree.map(lambda a: jnp.asarray(f64(a)), params),
                                    tok, jnp.asarray(f64(enc)))
    got64 = _port_stack(dataclasses.replace(cfg, dtype=torch.float64),
                        params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                        device="cpu").to(torch.float64),
                        tok_t, torch.from_numpy(f64(enc)), start64)
    assert sorted(got) == sorted(ref) == sorted(got64) == sorted(ref64)
    for name in ref:
        assert got[name].dtype == torch.bfloat16 and got64[name].dtype == torch.float64, name
        close64(ref64[name], got64[name], 1e-9, name)
        no_worse(ref64[name], ref[name], got[name], name)


def test_whisper_decode_matches_forward():
    """test_serve_consistency.py::test_decode_matches_forward's whisper case
    on the port: prefill, then decode token by token through the serve
    steps, against the train-mode decoder stack (2e-2, as the JAX test)."""
    cfg = smoke_config(all_configs()["whisper-tiny"])
    gen = torch.Generator().manual_seed(3)
    model = build_model(cfg, device="cpu").init(gen)
    B, S_pre, S_total = 2, 24, 30
    tokens = torch.randint(0, cfg.vocab_size, (B, S_total), generator=gen)
    frames = torch.randn((B, cfg.encoder_frames, cfg.d_model), generator=gen).bfloat16()
    enc = ted.encode(cfg, model, frames)
    full, _ = ted.decode_stack(cfg, model, tokens, enc, mode="train")
    max_len = S_total + 4
    prefill_fn, decode_fn, abstract = make_serve_steps(model, batch=B, max_len=max_len)
    logits_pre, pc = prefill_fn({"tokens": tokens[:, :S_pre], "frames": frames})
    close(full[:, S_pre - 1], logits_pre[:, 0], 2e-2)
    caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, S_pre)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), caches) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), abstract)
    for t in range(S_pre, S_total):
        _, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t)
        close(full[:, t], logits_d[:, 0], 2e-2, "decode step %d" % t)


# ---------------------------------------------------------------------------
# the two configs at smoke width against the JAX package
# ---------------------------------------------------------------------------

B, PROMPT, TOTAL = 2, 24, 28
_runs = {}


def _run(arch, wide=False):
    """Both packages: loss, prefill logits and caches, three decode steps;
    ``wide``, both in fp64 from the same weights and inputs."""
    if (arch, wide) in _runs:
        return _runs[arch, wide]
    jcfg = jax_smoke(jax_configs()[arch])
    cfg = smoke_config(all_configs()[arch])
    params = jax_build(jcfg).init(jax.random.PRNGKey(3))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    if wide:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float64)
        cfg = dataclasses.replace(cfg, dtype=torch.float64)
        model = model.to(torch.float64)
        model.cfg = cfg
    with jax_fp64() if wide else contextlib.nullcontext():
        if wide:
            params = jax.tree.map(lambda a: jnp.asarray(f64(a)), params)
        jm = jax_build(jcfg)
        out = _both(jm, params, cfg, model, wide)
    _runs[arch, wide] = out
    return out


def _both(jm, params, cfg, model, wide):
    jcfg = jm.cfg
    ctx = jax_ctx()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, TOTAL + 1), dtype=np.int32)
    extra, extra_t = {}, {}
    if cfg.family == "audio":
        frames = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        frames = np.asarray(jnp.asarray(frames).astype(jnp.bfloat16))
        if wide:
            frames = f64(frames)
        extra["frames"] = jnp.asarray(frames)
        extra_t["frames"] = to_tensor(frames)
    tok, tok_t = jnp.asarray(tokens), torch.from_numpy(tokens)
    out = {"cfg": cfg, "model": model, "params": params}
    out["loss"] = (strict(lambda p, b: jm.loss(p, b, ctx), params, {"tokens": tok, **extra}),
                   model.loss({"tokens": tok_t, **extra_t}))
    jlogits, jcaches = strict(lambda p, b: jm.prefill(p, b, ctx), params,
                              {"tokens": tok[:, :PROMPT], **extra})
    max_len = TOTAL + 4
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)
    logits, caches = prefill_fn({"tokens": tok_t[:, :PROMPT], **extra_t})
    out["prefill"] = (jlogits, logits)
    out["prefill_caches"] = (jcaches, caches)
    if cfg.family == "ssm":  # the JAX package decodes from the prefill caches as they are
        jc, tc = jcaches, prefill_to_decode_caches(cfg, model, caches, B, max_len, PROMPT)
    else:
        jc = jax_to_decode(jcfg, jm, jcaches, B, max_len, PROMPT)
        tc = prefill_to_decode_caches(cfg, model, caches, B, max_len, PROMPT)
    steps = []
    for t in range(PROMPT, PROMPT + 3):
        jl_d, jc = strict(lambda p, x, c, pos: jm.decode_step(p, x, c, pos, ctx), params,
                          tok[:, t : t + 1], jc, jnp.int32(t))
        _, tl_d, tc = decode_fn(tok_t[:, t : t + 1], tc, t)
        steps.append((jl_d, tl_d))
    out["decode"] = steps
    out["decode_caches"] = (jc, tc)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss(arch):
    (ref, metrics), (got, metrics_t) = _run(arch)["loss"]
    assert float(got) == pytest.approx(float(ref), rel=1e-2)
    assert sorted(metrics_t) == sorted(metrics) == ["nll", "tokens", "z_loss"]
    assert float(metrics_t["nll"]) == pytest.approx(float(metrics["nll"]), rel=1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits(arch):
    ref, got = _run(arch)["prefill"]
    assert got.shape == ref.shape == (B, 1, _run(arch)["cfg"].vocab_size)
    close(ref, got, MODEL_TOL)


def _leaves(ref, got):
    """(name, JAX leaf, port leaf) of two cache trees, the port's found by
    the JAX leaf's path."""
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert leaves
    for path, leaf in leaves:
        node = got
        for k in path:
            node = node[k.key] if hasattr(k, "key") else node[k.idx]
        name = jax.tree_util.keystr(path)
        assert tuple(node.shape) == leaf.shape, name
        assert node.dtype == to_tensor(np.asarray(leaf)).dtype, name
        yield name, leaf, node


@pytest.mark.parametrize("key", ["prefill_caches", "decode_caches"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_caches(arch, key):
    """Every cache leaf, the sLSTM's state tuple included, at its shape and
    dtype. The xLSTM's within 3e-2 relative and 3e-2 of the leaf's std
    absolute. Whisper's as its decoder stack is held
    (``test_decode_stack_modes``): both packages in fp64 within 1e-9, and
    each bf16 leaf no further from the JAX package's fp64 leaf than
    ``NO_WORSE`` times the JAX package's own, in mean and max error (its
    K/V have a std near 6, as the JAX init draws wk and wv with fan_in =
    the head count, and near-hard attention turns one bf16 rounding that
    lands the other way into up to 0.5 on an element; module docstring)."""
    ref, got = _run(arch)[key]
    if arch == "whisper-tiny":
        ref64, got64 = _run(arch, wide=True)[key]
        wide = dict((name, (a, b)) for name, a, b in _leaves(ref64, got64))
        for name, leaf, node in _leaves(ref, got):
            close64(wide[name][0], wide[name][1], 1e-9, name)
            no_worse(wide[name][0], leaf, node, name)
        return
    for name, leaf, node in _leaves(ref, got):
        if name.endswith("['m']"):  # the -1e30 floor of an empty memory is exact
            assert np.array_equal(f32(leaf) <= -1e29, f32(node) <= -1e29), name
            continue
        np.testing.assert_allclose(f32(node), f32(leaf), rtol=MODEL_TOL,
                                   atol=MODEL_TOL * max(1.0, float(f32(leaf).std())),
                                   err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_decode_steps(arch):
    for step, (ref, got) in enumerate(_run(arch)["decode"]):
        close(ref, got, MODEL_TOL, "decode step %d" % step)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_round_trip(arch):
    """params_to_jax inverts params_from_jax bit for bit, two-level stacks
    (the xLSTM's [groups, blocks, ...]) included."""
    run = _run(arch)
    back = params_to_jax(run["model"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(run["params"]):
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == np.asarray(leaf).dtype and np.array_equal(
            np.asarray(leaf).view(np.uint16), node.view(np.uint16)), path


def test_build_model_on_the_cpu():
    """Both families build, count param_count() parameters, hold the
    xLSTM's groups as nested lists, and default to the card."""
    x = build_model(smoke_config(all_configs()["xlstm-350m"]), device="cpu")
    w = build_model(all_configs()["whisper-tiny"], device="meta")
    assert isinstance(x, XLSTMModel) and isinstance(w, EncDecModel)
    for model in (x, w):
        assert sum(p.numel() for p in model.parameters()) == model.cfg.param_count()
    assert len(x["mlstm"]) == 2 and len(x["mlstm"][0]) == x.n_m == 1
    assert x.param_leaf(("mlstm", "w_qkv"))[1][0] is x["mlstm"][1][0]["w_qkv"]
    full = build_model(all_configs()["xlstm-350m"], device="meta")
    assert full.n_m == 7 and len(full["mlstm"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_model(smoke_config(all_configs()["whisper-tiny"]))


def test_xlstm_decode_caches_match_the_jax_layout():
    cfg = smoke_config(all_configs()["xlstm-350m"])
    jm = jax_build(jax_smoke(jax_configs()["xlstm-350m"]))
    ref = jm.init_decode_caches(3, 16)
    got = build_model(cfg, device="cpu").init_decode_caches(3, 16)
    assert isinstance(got["s"], tuple)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = got
        for k in path:
            node = node[k.key] if hasattr(k, "key") else node[k.idx]
        assert tuple(node.shape) == leaf.shape and np.array_equal(np.asarray(leaf), node.numpy())


def test_families_in_fp64_decode_equals_the_forward():
    """Cast to fp64, each family's decode equals its forward to fp64
    rounding (1e-9): what the card's fp64 check holds too."""
    for arch in FAMILIES:
        cfg = dataclasses.replace(smoke_config(all_configs()[arch]), dtype=torch.float64)
        gen = torch.Generator().manual_seed(7)
        model = build_model(cfg, device="cpu").init(gen).to(torch.float64)
        tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=gen,
                                          dtype=torch.float64)
            full, _ = ted.decode_stack(cfg, model, tokens, ted.encode(cfg, model, extra["frames"]))
        else:
            full, _ = model._run(tokens, mode="train")
        prefill_fn, decode_fn, _ = make_serve_steps(model, batch=2, max_len=12)
        logits, pc = prefill_fn({"tokens": tokens[:, :8], **extra})
        caches = prefill_to_decode_caches(cfg, model, pc, 2, 12, 8)
        torch.testing.assert_close(logits[:, 0], full[:, 7], rtol=1e-9, atol=1e-9)
        for t in range(8, 12):
            _, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t)
            torch.testing.assert_close(logits_d[:, 0], full[:, t], rtol=1e-9, atol=1e-9,
                                       msg="%s step %d" % (arch, t))
