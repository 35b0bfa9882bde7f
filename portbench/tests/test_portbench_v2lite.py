"""The ``decode.deepseek-v2-lite`` cell on the host: its small run is
correct, and each fault of the program makes it not correct (RoPE without
YaRN, the top-k weights renormalised, the capacity-bounded dispatch in
place of dropless, the dropless path's groups misplaced, a served token
altered); ``arith_mla`` against counts
made by hand; each of its per-layer readers on a synthetic run."""

import time
from types import SimpleNamespace

import pytest

from portbench import arith, arith_mla, harness, inputs_mla

CELL = "decode.deepseek-v2-lite"


def run_small(seed: int = 2 ** 31 + 99, **traffic):
    """The cell's driver at its small size; the window (3 s) holds the
    whole first round of 16 steps that the check reads, on a busy host too."""
    m = harness.Manifest()
    c = m.cell(CELL)
    tr = m.traffic(c["traffic"])
    cfg, tr = harness.driver(tr["driver"]).small(m.config(c["config"]), tr)
    return harness.run_cell(m, CELL, seed=seed, seconds=3.0, trace=False, device="cpu",
                            t_start=time.monotonic(), config=cfg, traffic=dict(tr, **traffic))


def test_sound():
    run = run_small()
    assert run.correct, run.checks
    assert run.checks["dropped_pairs"]["value"] == 0
    assert run.data["pairs"]["routed"] == 4 * 2 * 2 * len(run.data["positions"])


@pytest.mark.parametrize("fault", ["plain_rope", "renormalized"])
def test_fault_moves_a_served_token(fault):
    run = run_small(fault=fault)
    assert not run.correct, run.checks
    assert run.checks["served_logit_gap"]["value"] > run.checks["served_logit_gap"]["limit"]


def test_capacity_dispatch_drops_pairs():
    run = run_small(fault="capacity")
    assert not run.correct and run.checks["dropped_pairs"]["value"] > 0


@pytest.mark.parametrize("fault", ["renormalized", "grouping"])
def test_fault_moves_the_routed_experts(fault):
    """The routed experts' own comparison sees a fault in their weights or
    in the dropless path's grouping, whatever the served tokens show."""
    run = run_small(fault=fault)
    assert run.checks["experts_gap"]["value"] > run.checks["experts_gap"]["limit"]
    assert run.checks["dropped_pairs"]["value"] == 0


def test_planted_grouping_is_undone():
    import torch

    from portbench.drivers import decode_mla

    real = torch._grouped_mm
    a = torch.ones(4, 8)
    b = torch.stack([torch.ones(8, 4), 2 * torch.ones(8, 4)])
    offs = torch.tensor([2, 4], dtype=torch.int32)
    with decode_mla.planted("grouping"):
        assert torch._grouped_mm is not real
        # the first expert's last row runs through the second's weights
        assert torch._grouped_mm(a, b, offs=offs)[:, 0].tolist() == [8, 16, 16, 16]
    with decode_mla.planted(None):
        assert torch._grouped_mm is real
    assert torch._grouped_mm is real


def test_routed_scale_other_than_one_is_refused():
    from portbench.drivers import decode_mla
    from portbench.reference import deepseek_v2

    cfg = dict(LITE, routed_scaling_factor=16)
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        decode_mla.program_config(cfg)
    with pytest.raises(ValueError, match="routed scale"):
        deepseek_v2.Decoder(cfg, {})


def test_token_altered(monkeypatch):
    from repro_torch.serve import serve_step

    real = serve_step.make_serve_steps

    def altered(*args, **kw):
        prefill_fn, decode_fn, caches = real(*args, **kw)

        def wrong(tokens, caches, pos):
            nxt, logits, caches = decode_fn(tokens, caches, pos)
            return (nxt + 1) % 256, logits, caches

        return prefill_fn, wrong, caches

    monkeypatch.setattr(serve_step, "make_serve_steps", altered)
    run = run_small()
    assert not run.correct, run.checks


# -- the arithmetic ------------------------------------------------------------------

LITE = harness.Manifest().config("deepseek-v2-lite")


def test_arith_against_hand_counts():
    D, V, H, L = 2048, 102400, 16, 27
    mla = D * H * 192 + D * 576 + 512 + 512 * H * 128 * 2 + H * 128 * D + 2 * D
    experts = 64 * 3 * D * 1408
    moe = D * 64 + experts + 3 * D * 2816
    assert inputs_mla.param_count(LITE) == 2 * V * D + D + L * mla + 3 * D * 10944 + 26 * moe \
        == 15706484224
    active = L * (D * H * 192 + D * 576 + H * 128 * D) + 3 * D * 10944 \
        + 26 * (D * 64 + 3 * D * 1408 * 8) + D * V
    assert arith_mla.active_matmul_weights(LITE) == active
    pos = 5000
    attn = 2 * 16 * (128 * 512 + (pos + 1) * (576 + 512) + 512 * 128)
    assert arith_mla.decode_step_flops(LITE, 96, pos) == 96 * (2 * active + L * attn)
    per_pos = L * 576 * 2
    assert arith_mla.latent_bytes_per_position(LITE) == 31104
    assert arith_mla.decode_step_bytes(LITE, 96, pos) == \
        2 * 15706484224 + 96 * (pos + 1) * per_pos + 96 * per_pos + 96 * V * 2
    assert arith_mla.decode_step_least_s(LITE, 96, pos) == pytest.approx(
        arith_mla.decode_step_bytes(LITE, 96, pos) / 3.35e12)  # bandwidth-bound
    assert arith_mla.expert_products_bytes(LITE, 576) == (experts + 2 * 576 * D) * 2
    assert arith_mla.moe_layers(LITE) == 26


# -- the per-layer readers ------------------------------------------------------------


def _run(program=None, trace=None):
    return SimpleNamespace(config=LITE, window_s=2.0, trace_summary=trace,
                           data={"batch": 96, "positions": [4096, 4097, 4098],
                                 **({"program": program} if program is not None else {})})


def _program(by_span, busy=1.0, dropped=0):
    return {"busy_s": busy, "window_s": 2.0, "device_by_span": by_span,
            "program_spans_dropped": dropped}


def test_decode_mfu_reader():
    got = harness.metric_reader("decode_mfu.v2lite")(_run())
    least = sum(arith_mla.decode_step_least_s(LITE, 96, p) for p in (4096, 4097, 4098))
    assert got == pytest.approx(100 * least / 2.0)


def test_idle_reader():
    read = harness.metric_reader("idle_pct.decode")  # the decode cells' one idle share
    assert read(_run(trace={"busy_s": 1.5, "window_s": 2.0})) == pytest.approx(25.0)
    assert read(_run()) is None


def test_mla_share_reader():
    read = harness.metric_reader("mla_device_pct.v2lite")
    assert read(_run(_program({"mla.attend": 0.6, "moe.experts": 0.3}))) == pytest.approx(60.0)
    assert read(_run(_program({"mla.attend": 0.6}, dropped=1))) is None
    assert read(_run(_program({"outside": 1.0}))) is None
    assert read(_run()) is None  # no program trace: the parent program, or an untraced run


def test_experts_roofline_reader():
    read = harness.metric_reader("experts_roofline_pct.v2lite")
    nbytes = 3 * 26 * arith_mla.expert_products_bytes(LITE, 96 * 6)
    secs = nbytes / arith.HBM_BYTES_PER_S * 2  # half the roofline
    assert read(_run(_program({"moe.experts": secs}))) == pytest.approx(50.0)
    assert read(_run(_program({"mla.attend": 1.0}))) is None
    assert read(_run()) is None
