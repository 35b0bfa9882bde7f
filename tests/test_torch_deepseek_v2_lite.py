"""DeepSeek-V2-Lite in repro_torch (``configs/deepseek_v2_lite.py``):
latent attention with a direct query projection under YaRN, greedy
routing without renormalisation, and dropless experts on
``torch._grouped_mm``, held at a small size on the CPU against the
benchmark's plain reference (``portbench/reference/deepseek_v2.py``) on
seeded weights (``portbench/inputs_mla.py``).

The small configuration is the benchmark cell's own cut
(``portbench/drivers/decode_mla.SMALL_MODEL``) with 8 routed experts:
d_model 64, 4 heads, kv_lora 16, rope 8, nope 8, v 8, 8 routed experts
top-2 and 1 shared, one dense and two MoE layers, YaRN at factor 40 from
an origin of 16 positions. ``torch._grouped_mm`` takes fp32, bf16 and fp16 and refuses
fp64, so the program is held in fp32 here, where other families use fp64.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import inputs_mla  # noqa: E402
from portbench.drivers import decode_mla  # noqa: E402
from portbench.drivers.decode_loop import _lay  # noqa: E402
from portbench.reference import deepseek_v2  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.configs.base import model_settings  # noqa: E402
from repro_torch.configs.deepseek_v2_lite import CONFIG  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402

FULL = json.loads((ROOT / "portbench" / "configs" / "deepseek-v2-lite.json").read_text())
#: The cut, with 8 routed experts (its weights drawn at 0.3, so that
#: attention and routing are far from uniform at these widths).
SMALL = dict(FULL, **dict(decode_mla.SMALL_MODEL, n_routed_experts=8))
SEED = 2 ** 31 + 29
#: fp32 program against the fp32 reference: the same arithmetic in
#: another order (MLA's two score products summed against one over the
#: concatenated head, another summation order of the experts), a few
#: roundings of fp32 through 3 layers.
FP32_REL = 1e-5
#: bf16 program against the fp32 reference, by the norm of the gap over
#: the reference's: bf16 activations through 3 layers at sharp attention,
#: and the routing choices rounding flips (whose tokens take other experts,
#: which the max of the gap feels whole): 3.1-4.3 % on four seeds, where
#: renormalised top-k reads 11-13 % and the reference in fp8 29-32 %.
BF16_NORM_REL = 6e-2


def _model(cfg=SMALL, dtype=torch.float32, seed=SEED, **replaced):
    pc = dataclasses.replace(decode_mla.program_config(cfg), dtype=dtype, **replaced)
    model = build_model(pc, device="cpu")
    decode_mla.load_weights(model, cfg, seed, "cpu")
    if dtype == torch.float32:
        model.float()
    return model


def _reference(cfg=SMALL, seed=SEED, **kw):
    return deepseek_v2.Decoder(cfg, inputs_mla.weights(cfg, seed, "cpu"), **kw)


def _tokens(seed, B, S):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 512, (B, S))).to(torch.int32)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# -- the configuration ------------------------------------------------------------


def test_the_ten_stay_ten_and_lite_is_not_registered():
    assert len(all_configs()) == 10 and CONFIG.name not in all_configs()
    assert model_settings(all_configs()["deepseek-v2-236b"]) == model_settings(
        all_configs()["granite-3-2b"])
    assert model_settings(CONFIG).dropless and not model_settings(CONFIG).norm_topk_prob


def test_the_benchmark_runs_the_port_config():
    """The cell's configuration is the port's ``CONFIG``, and both count the
    published shapes' parameters."""
    pc = decode_mla.program_config(FULL)
    assert dataclasses.replace(pc, name=CONFIG.name, attn_q_chunk=CONFIG.attn_q_chunk,
                               remat_policy=CONFIG.remat_policy) == CONFIG
    assert CONFIG.param_count() == inputs_mla.param_count(FULL) == FULL["parameters"]


# -- YaRN ---------------------------------------------------------------------------


def test_yarn_frequencies_and_scale_against_the_closed_form():
    yarn = CONFIG.yarn
    got = layers.yarn_frequencies(yarn, 64, 10000.0)
    corr = lambda n: 64 * math.log(4096 / (2 * math.pi * n)) / (2 * math.log(10000))  # noqa: E731
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    for i in range(32):
        ramp = min(1.0, max(0.0, (i - low) / (high - low)))
        f = 10000.0 ** (-2 * i / 64)
        assert got[i] == np.float32(f * (1 - ramp) + f / 40 * ramp), i
    np.testing.assert_array_equal(got, deepseek_v2.yarn_inv_freq(FULL["rope_scaling"], 64, 1e4))
    freqs, rotated, temperature = layers.yarn_rope(yarn, 64, 10000.0, torch.device("cpu"))
    assert rotated == 1.0 and torch.equal(freqs, torch.from_numpy(got))
    assert temperature == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2)
    assert 192 ** -0.5 * temperature == pytest.approx(0.1147214, abs=5e-8)


def test_apply_rope_default_is_unchanged():
    """The default path computes what it did before frequencies could be
    passed, bit for bit, and passing theta's own frequencies changes
    nothing."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, 3, 16, generator=g).to(torch.bfloat16)
    pos = torch.arange(7)[None].expand(2, 7)
    xf = x.float()
    freqs = torch.from_numpy(layers.rope_frequencies(16, 10000.0))
    ang = pos[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    before = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    assert torch.equal(layers.apply_rope(x, pos, 10000.0), before)
    assert torch.equal(layers.apply_rope(x, pos, 10000.0, freqs), before)


# -- the model against the reference ---------------------------------------------------


@pytest.mark.parametrize("seed", [SEED, 7])
def test_forward_fp32_matches_the_reference(seed):
    toks = _tokens(seed, 2, 24)
    with torch.no_grad():
        got = _model(seed=seed).logits({"tokens": toks})
        ref = _reference(seed=seed).logits(toks)
    assert _rel(got, ref) < FP32_REL


@pytest.mark.parametrize("seed", [SEED, 7])
def test_forward_bf16_within_its_bound(seed):
    toks = _tokens(seed, 2, 24)
    with torch.no_grad():
        got = _model(dtype=torch.bfloat16, seed=seed).logits({"tokens": toks})
        ref = _reference(seed=seed).logits(toks)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).norm() / ref.norm()) < BF16_NORM_REL


def test_each_fault_moves_the_forward_past_its_bound():
    """Plain RoPE and renormalised top-k, in the program alone, land far
    outside the fp32 bound: the test above sees them."""
    toks = _tokens(SEED, 2, 24)
    with torch.no_grad():
        ref = _reference().logits(toks)
        for fault in ({"yarn": None}, {"norm_topk_prob": True}):
            assert _rel(_model(**fault).logits({"tokens": toks}), ref) > 100 * FP32_REL, fault


@pytest.mark.parametrize("prompt", [16, 20])
def test_prefill_then_decode_matches_the_full_forward(prompt):
    """Prefill ``prompt`` positions, lay them into a decode cache of 32, and
    decode teacher-forced to position 31 (past YaRN's origin of 16): every
    step's logits against the reference's full forward."""
    B, S = 2, 32
    toks = _tokens(SEED + prompt, B, S)
    model = _model()
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=S)
    caches = model.init_decode_caches(B, S)
    logits, pc = prefill_fn({"tokens": toks[:, :prompt]})
    _lay(caches, pc, slice(0, B))
    steps = [logits[:, -1]]
    for pos in range(prompt, S - 1):
        _, logits, _ = decode_fn(toks[:, pos : pos + 1], caches, pos)
        steps.append(logits[:, -1])
    with torch.no_grad():
        ref = _reference().logits(toks[:, : S - 1], first=prompt - 1)
    assert _rel(torch.stack(steps, dim=1), ref) < FP32_REL


# -- dropless experts ------------------------------------------------------------------


def _one_expert_layer(seed=5):
    """Layer 1's experts with the router forced onto experts 3 and 7 for
    every token (positive inputs, a router whose columns rank them first)."""
    W = inputs_mla.weights(SMALL, seed, "cpu")
    W["layers.1.router"] = torch.tensor([0.01, 0.02, 0.03, 0.1, 0.04, 0.05, 0.06, 0.07]).expand(
        64, 8).to(torch.bfloat16).contiguous()
    model = build_model(dataclasses.replace(decode_mla.program_config(SMALL),
                                            dtype=torch.float32), device="cpu")
    with torch.no_grad():
        for name, t in W.items():
            decode_mla.program_leaf(model, SMALL, name).copy_(t)
    model.float()
    h = torch.rand(2, 24, 64, generator=torch.Generator().manual_seed(seed)) + 0.1
    return model["moe_layers"][0]["moe"], h, deepseek_v2.Decoder(SMALL, W)


def _moe(p, h, **kw):
    return moe.moe_layer(p, h, top_k=2, activation="silu", norm_topk_prob=False, **kw)[0]


def test_dropless_keeps_every_pair_on_one_expert():
    p, h, ref = _one_expert_layer()
    routed = ref.route(1, h.reshape(-1, 64))[1]
    assert set(routed.flatten().tolist()) == {3, 7}
    moe.count_pairs("cpu")
    y = _moe(p, h, dropless=True)
    assert moe.pair_counts() == {"routed": 96, "dropped": 0, "largest_expert": 48}
    flat = h.reshape(-1, 64)
    w, idx = ref.route(1, flat)
    want = ref.experts(1, flat, w, idx).reshape(h.shape)
    assert _rel(y, want) < FP32_REL
    # the capacity-bounded path (factor 1.25) drops most of them
    moe.count_pairs("cpu")
    capped = _moe(p, h, capacity_factor=1.25)
    counts = moe.pair_counts()
    assert counts["routed"] == 96 and counts["dropped"] > 40
    assert _rel(capped, want) > 0.1


def test_dropless_refuses_a_mesh():
    p, h, _ = _one_expert_layer()
    with pytest.raises(ValueError, match="one device"):
        _moe(p, h, dropless=True, mesh={"data": 2, "model": 1})


# -- spans and counters -------------------------------------------------------------------


def _decode_once(model, B=2, S=24):
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=S)
    caches = model.init_decode_caches(B, S)
    toks = _tokens(1, B, 20)
    _, pc = prefill_fn({"tokens": toks})
    _lay(caches, pc, slice(0, B))
    decode_fn(toks[:, -1:], caches, 20)


def test_spans_only_when_tracing():
    model = _model(dtype=torch.bfloat16)
    trace.disable_tracing()
    trace.reset_tracing()
    _decode_once(model)
    assert not trace.drain_spans()
    trace.enable_tracing()
    try:
        _decode_once(model)
        names = [s["name"] for s in trace.drain_spans()]
    finally:
        trace.disable_tracing()
    # prefill and one decode step: each layer's attention, each MoE layer's
    # router and experts, once a call
    assert names.count("mla.attend") == 2 * 3
    assert names.count("moe.route") == names.count("moe.experts") == 2 * 2
    assert names.count("serve.decode_step") == 1


def test_counters_count_on_the_device_once_read():
    model = _model(dtype=torch.bfloat16)
    assert moe.pair_counts() is None
    moe.count_pairs("cpu")
    _decode_once(model)
    counts = moe.pair_counts()
    # 2 MoE layers: prefill of 2 x 20 tokens, then one step of 2, 2 pairs each
    assert counts["routed"] == 2 * (2 * 20 * 2 + 2 * 2) and counts["dropped"] == 0
    assert 1 <= counts["largest_expert"] <= 2 * 20
    assert moe.pair_counts() is None
