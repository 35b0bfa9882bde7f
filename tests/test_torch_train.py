"""repro_torch.train, .distributed.compression and .checkpoint against the
JAX package on the CPU.

The pieces on the same trees (``lr_schedule``, ``compress``,
``quantize_with_feedback``, ``global_norm``, ``adamw_update``), the decay
rule on stacked leaves held per layer, then the train step of four configs
at smoke width against the JAX package's ``make_train_step`` from the same
weights and batches, the port's counterparts of ``tests/test_train.py``,
and checkpoints that each package restores from the other.

The fp32 train-step comparison softens attention first (wq and wk x 1/8 on
both sides). The JAX package's init draws wq and wk with fan_in = the head
count, so at smoke width the attention scores have a std near 30 and
attention is nearly hard: the gradients are then ill-conditioned, and the
fp32 gradients of either package, or of the JAX package in fp64, lie about
1 % from the port's fp64 gradient (whisper-tiny). Adam turns such
differences into whole steps of lr on the small elements. With soft
attention both packages agree to about 1e-7 in loss and gradient norm.
What is left after 3 steps are elements where a rounding decision lands the
other way and Adam, which normalizes each element, turns it into a step of
up to lr: the key bias, whose gradient is zero in exact arithmetic (a shift
shared by all keys leaves the softmax unchanged), so both packages step on
rounding noise; the bf16 cast of accumulated gradients; and an int8 step of
the compressed gradient. Measured over the 12 cases: loss and gradient
norm within 2.3e-5 (relative); outside the key biases at most 2 elements of
a leaf are over 1e-4 apart without compression, and with it at most 2.3e-4
of a leaf's elements (78 of w_qkv's 393 216, xlstm-350m), the worst 1.05e-3
apart (lr 1e-3). So every element is held within 1e-4, except at most
max(2, 1e-4 of the leaf) elements (1e-3 with compression) within 2 lr, and
the key biases within 3 lr (three steps of rounding noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _jax_port import f32, jax_ctx
from repro import checkpoint as jckpt
from repro.configs import all_configs as jax_configs
from repro.configs import smoke_config as jax_smoke
from repro.distributed import compression as jcomp
from repro.models import build_model as jax_build
from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_train_step as jax_train_step
from repro.train import optimizer as jopt
from repro_torch import checkpoint as tckpt
from repro_torch.configs import all_configs, smoke_config
from repro_torch.distributed import compression as tcomp
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax, to_tensor
from repro_torch.models.layers import members, stacked, tree_leaves, tree_map_leaves
from repro_torch.train import AdamWConfig, init_train_state, lr_schedule, make_train_step
from repro_torch.train import optimizer as topt

ARCHS = ["granite-3-2b", "deepseek-moe-16b", "xlstm-350m", "whisper-tiny"]
VARIANTS = {"plain": (1, False), "accum2": (2, False), "compressed": (1, True)}
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3
TIGHT = 1e-4


def _stack(tree):
    """A port tree as the JAX package's: stacked leaves, numpy fp32."""
    return tree_map_leaves(lambda leaf: f32(stacked(leaf)), tree)


def _leaves_by_path(ref, got):
    """(name, ref leaf, got leaf) over the JAX tree ``ref``."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = got
        for key in path:
            node = node[key.key]
        yield "/".join(str(key.key) for key in path), leaf, node


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_jax(step):
    cfg = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100, end_lr_fraction=0.1)
    ref = float(jopt.lr_schedule(JaxAdamW(**cfg), jnp.int32(step)))
    got = lr_schedule(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(ref, rel=1e-6, abs=1e-12)


def test_lr_schedule_shape():
    """The port's counterpart of test_train.py::test_lr_schedule_shape."""
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, end_lr_fraction=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3, rel=0.01)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.05)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=-1e3, max_value=1e3, allow_nan=False), min_size=1, max_size=64))
def test_compress_bounded_error(vals):
    """test_train.py's property, on the port: the error is at most half a
    step, and q and the scale equal the JAX package's bit for bit (both
    round half to even)."""
    x = np.array(vals, np.float32)
    q, scale = tcomp.compress(torch.from_numpy(x))
    err = np.abs(tcomp.decompress(q, scale).numpy() - x)
    assert err.max() <= float(scale) * 0.5 + 1e-6
    jq, jscale = jcomp.compress(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_compress_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, scale = tcomp.compress(x)
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    q, scale = tcomp.compress(torch.zeros(4))
    assert float(scale) == pytest.approx(1e-12)
    assert not q.any()


def test_compress_shares_one_scale_over_a_stacked_leaf():
    """Per-layer tensors of one stacked leaf quantize as the stacked array:
    one scale, the max over every layer."""
    rng = np.random.default_rng(0)
    layers = [rng.normal(size=(8, 4)).astype(np.float32) * s for s in (0.01, 3.0)]
    q, scale = tcomp.compress([torch.from_numpy(a) for a in layers])
    jq, jscale = jcomp.compress(jnp.asarray(np.stack(layers)))
    assert float(scale) == float(jscale)
    assert np.array_equal(torch.stack(q).numpy(), np.asarray(jq))


def _grad_trees(rng, scale=1.0):
    """One tree twice: the JAX package's stacked layout and the port's
    per-layer lists, bf16 and fp32 leaves, a two-level stack."""
    ref = {"embed": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
           "layers": {"norm": (rng.normal(size=(3, 8)) * 1e-3 * scale).astype(np.float32),
                      "w": np.asarray(jnp.asarray(rng.normal(size=(3, 8, 8)) * scale)
                                      .astype(jnp.bfloat16))},
           "mlstm": {"w": (rng.normal(size=(2, 2, 4, 4)) * scale).astype(np.float32)}}
    port = {"embed": to_tensor(ref["embed"]),
            "layers": {k: list(to_tensor(v).unbind(0)) for k, v in ref["layers"].items()},
            "mlstm": {"w": [list(t.unbind(0)) for t in to_tensor(ref["mlstm"]["w"]).unbind(0)]}}
    return ref, port


def test_error_feedback_matches_jax():
    rng = np.random.default_rng(1)
    ref, port = _grad_trees(rng)
    j_err = jcomp.init_error_state(jax.tree.map(jnp.asarray, ref))
    t_err = tcomp.init_error_state(port)
    for _ in range(4):
        j_out, j_err = jcomp.quantize_with_feedback(jax.tree.map(jnp.asarray, ref), j_err)
        t_out, t_err = tcomp.quantize_with_feedback(port, t_err)
        for name, a, b in _leaves_by_path(j_out, _stack(t_out)):
            assert np.array_equal(f32(a), b), name
        for name, a, b in _leaves_by_path(j_err, _stack(t_err)):
            np.testing.assert_allclose(b, f32(a), rtol=0, atol=1e-7, err_msg=name)
    assert members(t_out["layers"]["w"])[0].dtype == torch.bfloat16


def test_error_feedback_converges():
    """The port's counterpart of test_train.py::test_error_feedback_converges."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(rng.normal(size=128).astype(np.float32)) * 0.01 for _ in range(50)]
    err = tcomp.init_error_state({"w": g_true[0]})
    acc_q = torch.zeros(128)
    acc_t = torch.zeros(128)
    for g in g_true:
        out, err = tcomp.quantize_with_feedback({"w": g}, err)
        acc_q += out["w"]
        acc_t += g
    # residual bounded by one quantization step, NOT growing with t
    assert (acc_q - acc_t).abs().max() < 0.01


def test_global_norm_matches_jax():
    ref, port = _grad_trees(np.random.default_rng(2))
    assert float(topt.global_norm(port)) == pytest.approx(
        float(jopt.global_norm(jax.tree.map(jnp.asarray, ref))), rel=1e-6)


def test_adamw_update_matches_jax():
    """Three updates of the same trees: parameters in place, moments fp32,
    the step int32; clipping active (gradient norm above 1)."""
    rng = np.random.default_rng(3)
    p_ref, p_port = _grad_trees(rng)
    g_ref, g_port = _grad_trees(rng, scale=10.0)
    cfg = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    params = jax.tree.map(jnp.asarray, p_ref)
    state = jopt.init_opt_state(params)
    t_state = topt.init_opt_state(p_port)
    first = members(p_port["layers"]["w"])[0]
    for _ in range(3):
        params, state, metrics = jopt.adamw_update(JaxAdamW(**cfg), params,
                                                   jax.tree.map(jnp.asarray, g_ref), state)
        p_out, t_state, t_metrics = topt.adamw_update(AdamWConfig(**cfg), p_port, g_port, t_state)
        assert p_out is p_port and members(p_port["layers"]["w"])[0] is first
        assert float(t_metrics["grad_norm"]) == pytest.approx(float(metrics["grad_norm"]),
                                                              rel=1e-6)
        assert float(t_metrics["lr"]) == pytest.approx(float(metrics["lr"]), rel=1e-6)
    assert t_state["step"].dtype == torch.int32 and int(t_state["step"]) == 3
    assert members(t_state["m"]["layers"]["w"])[0].dtype == torch.float32
    assert first.dtype == torch.bfloat16
    for tree_ref, tree_port in ((params, p_port), (state["m"], t_state["m"]),
                                (state["v"], t_state["v"])):
        for name, a, b in _leaves_by_path(tree_ref, _stack(tree_port)):
            np.testing.assert_allclose(b, f32(a), rtol=1e-6, atol=1e-8, err_msg=name)


def test_weight_decay_follows_the_stacked_shape():
    """A per-layer norm [D] of a stack [L, D] decays (the JAX package
    decides on the stacked leaf, ndim 2); the top-level final_norm [D] does
    not. With zero gradients an update is the decay alone, so a rule on the
    per-layer ndim would leave every norm of the model unchanged."""
    jcfg = jax_smoke(jax_configs()["granite-3-2b"])
    cfg = smoke_config(all_configs()["granite-3-2b"])
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    for tree, key in ((params, "final_norm"), (params["layers"], "norm1"),
                      (params["layers"], "norm2")):
        tree[key] = jnp.full(tree[key].shape, 0.5, jnp.bfloat16)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tree = model.param_tree()
    zeros = tree_map_leaves(lambda leaf: [torch.zeros_like(t) for t in leaf]
                            if isinstance(leaf, list) else torch.zeros_like(leaf), tree)
    ocfg = dict(peak_lr=0.5, warmup_steps=1, total_steps=10, weight_decay=0.5)
    ref, _, _ = jopt.adamw_update(JaxAdamW(**ocfg), params, jax.tree.map(jnp.zeros_like, params),
                                  jopt.init_opt_state(params))
    topt.adamw_update(AdamWConfig(**ocfg), tree, zeros, topt.init_opt_state(tree))
    got = params_to_jax(model)
    for name, a, b in _leaves_by_path(ref, got):
        assert np.array_equal(f32(a), f32(b)), name
    # lr 0.5 x decay 0.5: the stacked norm shrinks by a quarter, final_norm stays
    assert np.all(f32(got["layers"]["norm1"]) == 0.375)
    assert np.all(f32(got["final_norm"]) == 0.5)


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

def _pair(arch, dtype, soften):
    """Both packages' model of ``arch`` at smoke width from one JAX init
    (wq and wk x 1/8 when ``soften``), cast to ``dtype``."""
    jcfg = jax_smoke(jax_configs()[arch])
    cfg = smoke_config(all_configs()[arch])
    params = jax_build(jcfg).init(jax.random.PRNGKey(3))
    if soften:
        params = jax.tree_util.tree_map_with_path(
            lambda path, p: (p.astype(jnp.float32) / 8).astype(p.dtype)
            if path[-1].key in ("wq", "wk") else p, params)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    if dtype == "fp32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        params = jax.tree.map(lambda p: p.astype(jnp.float32), params)
        model.to(torch.float32)
        model.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return jax_build(jcfg), params, model


def _batches(cfg, dtype, n=STEPS):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 33), dtype=np.int32)}
        if cfg.family == "audio":
            frames = jnp.asarray(rng.normal(size=(4, cfg.encoder_frames, cfg.d_model)),
                                 jnp.float32 if dtype == "fp32" else jnp.bfloat16)
            batch["frames"] = np.asarray(frames)
        out.append(batch)
    return out


def _both_trained(arch, dtype, variant, soften):
    grad_accum, compress = VARIANTS[variant]
    jm, params, model = _pair(arch, dtype, soften)
    ctx = jax_ctx()
    opt = jopt.init_opt_state(params)
    if compress:
        opt["grad_error"] = jcomp.init_error_state(params)
    j_step, _ = jax_train_step(jm, ctx.mesh, ctx.rules, JaxAdamW(**OPT), grad_accum=grad_accum,
                               compress_grads=compress)
    t_params = model.param_tree()
    t_opt = topt.init_opt_state(t_params)
    if compress:
        t_opt["grad_error"] = tcomp.init_error_state(t_params)
    t_step = make_train_step(model, AdamWConfig(**OPT), grad_accum=grad_accum,
                             compress_grads=compress)
    compiled, rows = None, []
    for batch in _batches(model.cfg, dtype):
        jb = jax.tree.map(jnp.asarray, batch)
        if compiled is None:
            compiled = j_step.lower(params, opt, jb).compile(
                compiler_options={"xla_allow_excess_precision": False})
        params, opt, metrics = compiled(params, opt, jb)
        t_batch = {k: to_tensor(v) for k, v in batch.items()}
        t_params, t_opt, t_metrics = t_step(t_params, t_opt, t_batch)
        rows.append((metrics, t_metrics))
    return params, model, rows, (opt, t_opt)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_fp32(arch, variant):
    params, model, rows, (opt, t_opt) = _both_trained(arch, "fp32", variant, soften=True)
    for i, (m, tm) in enumerate(rows):
        assert sorted(tm) == sorted(m), i
        assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=TIGHT), i
        assert float(tm["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=TIGHT), i
        assert float(tm["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6), i
        assert float(tm["tokens"]) == float(m["tokens"])
    lr = OPT["peak_lr"]
    for name, a, b in _leaves_by_path(params, params_to_jax(model)):
        d = np.abs(f32(a) - f32(b))
        if name.endswith("/bk"):  # zero gradient in exact arithmetic
            assert d.max() <= 3 * lr, name
            continue
        allowed = max(2, d.size * (1e-3 if VARIANTS[variant][1] else 1e-4))
        assert (d > TIGHT).sum() <= allowed, (name, int((d > TIGHT).sum()))
        assert d.max() <= 2 * lr, (name, float(d.max()))
    assert int(t_opt["step"]) == int(opt["step"]) == STEPS
    if VARIANTS[variant][1]:
        assert set(t_opt) == {"step", "m", "v", "grad_error"}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_matches_jax_bf16(arch, variant):
    """bf16, from the JAX init as drawn: the loss of each of 3 steps within
    3e-2 (relative)."""
    _, model, rows, _ = _both_trained(arch, "bf16", variant, soften=False)
    assert members(tree_leaves(model.param_tree())[0])[0].dtype == torch.bfloat16
    for i, (m, tm) in enumerate(rows):
        assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=3e-2), i
        assert np.isfinite(float(tm["grad_norm"]))


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

def _granite(seed, compress=False):
    cfg = smoke_config(all_configs()["granite-3-2b"])
    model = build_model(cfg, device="cpu")
    params, opt = init_train_state(model, torch.Generator().manual_seed(seed),
                                   compress_grads=compress)
    return cfg, model, params, opt


def _batch(vocab, B=4, S=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S + 1), dtype=np.int32)}


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
def test_loss_decreases(compress):
    """test_loss_decreases and test_compressed_grads_training_still_converges:
    15 steps on one batch take the loss below 0.7 (0.75 compressed) of the
    first."""
    cfg, model, params, opt = _granite(0, compress)
    step = make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=100),
                           compress_grads=compress)
    batch = _batch(cfg.vocab_size)
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < (0.75 if compress else 0.7) * losses[0]
    assert all(np.isfinite(losses))
    assert step.grad_devices == {"cpu"}


def test_grad_accum_equivalence():
    cfg, model, params, opt = _granite(1)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _batch(cfg.vocab_size, B=4)
    make_train_step(model, ocfg, grad_accum=1)(params, opt, batch)
    one = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(start)
    _, opt2 = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(1))
    make_train_step(model, ocfg, grad_accum=2)(params, opt2, batch)
    # same data, same update (up to bf16 accumulation noise)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v.float(), one[k].float(), rtol=3e-2, atol=3e-3, msg=k)


def test_train_state_and_serving_grads():
    """init_train_state draws the model and zeroes fp32 moments of every
    parameter; the step turns gradients on, and the serve steps run under
    inference mode regardless."""
    cfg, model, params, opt = _granite(2, compress=True)
    assert sorted(opt) == ["grad_error", "m", "step", "v"]
    n = sum(t.numel() for leaf in tree_leaves(opt["m"]) for t in members(leaf))
    assert n == sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert not any(p.requires_grad for p in model.parameters())
    make_train_step(model, AdamWConfig())
    assert all(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

DATA = {"shard_idx": 3, "byte_offset": 12345, "buffered_tokens": 0, "pending_buffer": 0}


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    cfg, model, params, opt = _granite(2, compress=True)
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10),
                           compress_grads=True)
    params, opt, _ = step(params, opt, _batch(cfg.vocab_size))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    moments = _stack(opt["m"])
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        tckpt.save_checkpoint(d, s, {"params": params, "opt": opt, "data": dict(DATA)}, keep_n=2)
    assert tckpt.latest_checkpoint(d).endswith("step_00000004")
    assert len([x for x in (tmp_path / "ckpt").iterdir() if x.name.startswith("step_")]) == 2

    _, model2, params2, opt2 = _granite(9, compress=True)
    template = {"params": params2, "opt": opt2,
                "data": {"shard_idx": 0, "byte_offset": 0, "buffered_tokens": 0,
                         "pending_buffer": 0}}
    s, restored = tckpt.restore_checkpoint(tckpt.latest_checkpoint(d), template)
    assert s == 4
    # written in place: the same tensors
    assert restored["params"]["embed"] is params2["embed"]
    assert restored["opt"]["m"]["layers"]["attn"]["wq"][1] is opt2["m"]["layers"]["attn"]["wq"][1]
    for k, v in model2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for name, a, b in _leaves_by_path(moments, _stack(restored["opt"]["m"])):
        assert np.array_equal(a, b), name
    assert int(restored["opt"]["step"]) == 1
    assert int(restored["data"]["byte_offset"]) == 12345


def test_checkpoint_refuses_another_dtype(tmp_path):
    _, model, params, opt = _granite(3)
    tckpt.save_checkpoint(str(tmp_path), 1, {"params": params})
    model.to(torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.restore_checkpoint(tckpt.latest_checkpoint(str(tmp_path)),
                                 {"params": model.param_tree()})


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-350m"])
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    """A checkpoint the port writes (a two-level stack for the xLSTM, the
    optimizer state and the pipeline's) restores in repro.checkpoint with
    every leaf equal, under the same keys."""
    cfg = smoke_config(all_configs()[arch])
    model = build_model(cfg, device="cpu")
    params, opt = init_train_state(model, torch.Generator().manual_seed(4), compress_grads=True)
    step_fn = make_train_step(model, AdamWConfig(warmup_steps=1), compress_grads=True)
    for seed in (0, 1):
        params, opt, _ = step_fn(params, opt, _batch(cfg.vocab_size, S=16, seed=seed))
    tckpt.save_checkpoint(str(tmp_path), 2, {"params": params, "opt": opt, "data": dict(DATA)})

    jm = jax_build(jax_smoke(jax_configs()[arch]))
    jparams = jm.init(jax.random.PRNGKey(0))
    jopt_state = jopt.init_opt_state(jparams)
    jopt_state["grad_error"] = jcomp.init_error_state(jparams)
    template = {"params": jax.tree.map(jnp.zeros_like, jparams),
                "opt": jax.tree.map(jnp.zeros_like, jopt_state),
                "data": {k: 0 for k in DATA}}
    step, restored = jckpt.restore_checkpoint(jckpt.latest_checkpoint(str(tmp_path)), template)
    assert step == 2
    want = params_to_jax(model)
    for name, a, b in _leaves_by_path(restored["params"], want):
        assert a.dtype == b.dtype and np.array_equal(f32(a), f32(b)), name
    for key in ("m", "v", "grad_error"):
        for name, a, b in _leaves_by_path(restored["opt"][key], _stack(opt[key])):
            assert a.dtype == jnp.float32 and np.array_equal(np.asarray(a), b), (key, name)
    assert int(restored["opt"]["step"]) == 2 and restored["opt"]["step"].dtype == jnp.int32
    assert int(restored["data"]["byte_offset"]) == 12345


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-tiny"])
def test_jax_checkpoint_restores_in_the_port(arch, tmp_path):
    """And the reverse: the JAX package's checkpoint after one train step,
    restored into a port model drawn from another seed, every leaf equal."""
    jcfg = jax_smoke(jax_configs()[arch])
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(5))
    opt = jopt.init_opt_state(params)
    ctx = jax_ctx()
    j_step, _ = jax_train_step(jm, ctx.mesh, ctx.rules, JaxAdamW(warmup_steps=1))
    batch = {k: jnp.asarray(v) for k, v in _batches(smoke_config(all_configs()[arch]), "bf16",
                                                    n=1)[0].items()}
    params, opt, _ = j_step(params, opt, batch)
    jckpt.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": opt, "data": dict(DATA)})

    cfg = smoke_config(all_configs()[arch])
    model = build_model(cfg, device="cpu")
    t_params, t_opt = init_train_state(model, torch.Generator().manual_seed(6))
    step, restored = tckpt.restore_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path)),
        {"params": t_params, "opt": t_opt, "data": {k: 0 for k in DATA}})
    assert step == 1
    for name, a, b in _leaves_by_path(params, params_to_jax(model)):
        assert np.array_equal(f32(a), f32(b)), name
    for key in ("m", "v"):
        for name, a, b in _leaves_by_path(opt[key], _stack(restored["opt"][key])):
            assert np.array_equal(np.asarray(a), b), (key, name)
    assert int(restored["opt"]["step"]) == 1
    assert int(restored["data"]["shard_idx"]) == 3
