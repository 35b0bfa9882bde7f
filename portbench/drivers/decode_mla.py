"""Greedy decode of a DeepSeek-V2 decoder (latent attention under YaRN,
dropless routed experts) in lockstep, as ``decode_loop`` decodes a dense
one. Set-up draws the prompts from the seeded corpus (``decode_loop.prompts``),
draws the weights straight into the program's parameters
(``inputs_mla.draw``), prefills the prompts through the program's prefill
step in groups, lays the caches into one decode cache of ``max_len``
positions (``decode_loop._lay``), and runs a few decode steps. The window
then runs ``make_serve_steps``' decode step until it closes, each step
timed to ``torch.cuda.synchronize()``; when the cache is full the next
round starts again from the prefilled positions (that restart is not a
step). The program counts its token-slot pairs on the device from the
prefill on (``moe.count_pairs``), read once before the window and once
after it. A traced window also runs the program's tracer
(``program_spans.ProgramTrace``), reduced into ``data["program"]``.

After the window one MoE layer of the program, drawn from the seed, runs
its routed experts once more at the decode step's shape over inputs drawn
from the seed (``experts_probe``). Then the program is freed and the
reference (``reference/deepseek_v2.py``, fp32) runs one full forward over
the prompt and served tokens of a sample of the sequences, drawn from the
seed: the widest gap by which a served token's logit lies below the
reference's best at its position is compared; so are the pairs the
program dropped, and the relative gap of that layer's routed experts to
the reference's (``experts_gap``: the routed experts weigh about a tenth
of a layer's output, so a fault in them hardly moves a served token)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np

from .. import inputs, inputs_mla
from ..harness import span
from .decode_loop import _lay, prompts

#: The host tests' size of the configuration: YaRN's origin at 16
#: positions, so the served positions lie past it as in the cell; weights
#: drawn at 0.3, as at these widths 0.02 leaves attention, routing and the
#: logits nearly uniform, and no fault would move a served token; 32
#: routed experts for 2 a token, so that a token's routed weights sum to
#: about a tenth, as the cell's 6 of 64 do (renormalising them then moves
#: the output as much).
SMALL_MODEL = {"initializer_range": 0.3, "num_hidden_layers": 3, "hidden_size": 64,
               "num_attention_heads": 4, "num_key_value_heads": 4, "intermediate_size": 128,
               "moe_intermediate_size": 32, "n_routed_experts": 32, "n_shared_experts": 1,
               "num_experts_per_tok": 2,
               "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
               "v_head_dim": 8, "vocab_size": 512, "attn_q_chunk": 16,
               "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                                "mscale_all_dim": 0.707, "original_max_position_embeddings": 16,
                                "type": "yarn"}}

#: What the program leaf of each reference leaf is, under its layer.
PROGRAM_LEAVES = {
    "norm1": ("norm1",), "norm2": ("norm2",), "w_q": ("attn", "w_q"),
    "w_dkv": ("attn", "w_dkv"), "kv_norm": ("attn", "kv_norm"), "w_uk": ("attn", "w_uk"),
    "w_uv": ("attn", "w_uv"), "wo": ("attn", "wo"), "w_gate": ("mlp", "w_gate"),
    "w_up": ("mlp", "w_up"), "w_down": ("mlp", "w_down"), "router": ("moe", "router"),
    "e_gate": ("moe", "w_gate"), "e_up": ("moe", "w_up"), "e_down": ("moe", "w_down"),
    "s_gate": ("moe", "shared", "w_gate"), "s_up": ("moe", "shared", "w_up"),
    "s_down": ("moe", "shared", "w_down"),
}

#: The program's faults the control reads (``control``): changes of the
#: program's configuration (RoPE without YaRN, the top-k weights
#: renormalised, the capacity-bounded dispatch (factor 1.25) in place of
#: dropless), and ``grouping``, a fault planted in the dropless path's
#: grouped products (``planted``).
FAULTS = {"plain_rope": {"yarn": None}, "renormalized": {"norm_topk_prob": True},
          "capacity": {"dropless": False}, "grouping": {}}


def small(cfg, tr):
    """The cell's configuration and traffic at the host tests' size (one
    prefill group of 4 x 24 tokens, whose pairs overfill an expert under
    the capacity-bounded dispatch)."""
    return (dict(cfg, **SMALL_MODEL),
            dict(tr, batch=4, prompt_len=24, max_len=40, prefill_group=4, checked_sequences=2))


def control(manifest, cell, cfg, tr, seed: int, *, device: str, seconds: float, **_) -> dict:
    """The program's decode for a short window, read against the
    reference and against the reference in fp8 (the gap of the token the
    fp8 reference puts first); then the program with each of ``FAULTS``,
    read as the program is."""
    from .. import harness

    def once(**extra):
        return harness.run_cell(manifest, cell, seed=seed, seconds=seconds, trace=False,
                                device=device, t_start=time.monotonic(), config=cfg,
                                traffic=dict(tr, **extra))

    sound = once(control=True)
    out = {"fp8": sound.data["control"],
           "program": {k: v["value"] for k, v in sound.checks.items()},
           "checked_tokens": sound.data["checked_tokens"]}
    for fault in FAULTS:
        out[fault] = {k: v["value"] for k, v in once(fault=fault).checks.items()}
    return out


@contextlib.contextmanager
def planted(fault=None):
    """``FAULTS``' code fault while it lasts: with ``grouping`` every
    grouped product ends each expert's group one row early, so each
    expert's last pair runs through the next expert's weights."""
    import torch

    if fault != "grouping":
        yield
        return
    real = torch._grouped_mm

    def misgrouped(a, b, *args, offs, **kw):
        ends = torch.cat([(offs[:-1] - 1).clamp(min=0), offs[-1:]])
        return real(a, b, *args, offs=ends, **kw)

    torch._grouped_mm = misgrouped
    try:
        yield
    finally:
        torch._grouped_mm = real


def program_config(cfg, fault=None):
    """The program's ``DeepSeekV2Config`` of the benchmark's configuration
    (with one of ``FAULTS`` where asked). The program scales the routed
    weights by 1 alone, Lite's ``routed_scaling_factor``."""
    from repro_torch.configs.base import DeepSeekV2Config, YarnRope

    if float(cfg["routed_scaling_factor"]) != 1.0:
        raise ValueError("routed_scaling_factor %r: the program scales routed weights by 1 only"
                         % cfg["routed_scaling_factor"])
    rs = cfg.get("rope_scaling")
    yarn = None if not rs else YarnRope(
        factor=float(rs["factor"]),
        original_max_position=int(rs["original_max_position_embeddings"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    out = DeepSeekV2Config(
        name="portbench-" + str(cfg["model_type"]), family="moe",
        n_layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]), n_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]), vocab_size=int(cfg["vocab_size"]),
        activation=str(cfg["hidden_act"]), rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        n_experts=int(cfg["n_routed_experts"]), n_shared_experts=int(cfg["n_shared_experts"]),
        top_k=int(cfg["num_experts_per_tok"]), d_ff_expert=int(cfg["moe_intermediate_size"]),
        first_dense_layers=int(cfg["first_k_dense_replace"]), use_mla=True,
        q_lora_rank=int(cfg["q_lora_rank"] or 0), kv_lora_rank=int(cfg["kv_lora_rank"]),
        qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
        qk_rope_head_dim=int(cfg["qk_rope_head_dim"]), v_head_dim=int(cfg["v_head_dim"]),
        attn_q_chunk=int(cfg["attn_q_chunk"]), remat_policy="none", yarn=yarn,
        norm_topk_prob=bool(cfg["norm_topk_prob"]), dropless=bool(cfg["dropless"]))
    return dataclasses.replace(out, **FAULTS[fault]) if fault else out


def program_leaf(model, cfg, name: str):
    """The program's parameter that holds the reference's leaf ``name``."""
    if "." not in name:
        return model[name]
    _, i, leaf = name.split(".")
    dense = int(cfg["first_k_dense_replace"])
    i = int(i)
    layer = model["dense_layers"][i] if i < dense else model["moe_layers"][i - dense]
    return layer.get(PROGRAM_LEAVES[leaf])


def load_weights(model, cfg, seed: int, device) -> None:
    """The benchmark's weights drawn straight into the program's model."""
    import torch

    with torch.no_grad():
        inputs_mla.draw(cfg, seed, device, lambda name, t: program_leaf(model, cfg, name).copy_(t))


def experts_probe(model, cfg, seed: int, tokens: int, fault=None) -> dict:
    """One MoE layer of the program, drawn from the seed, over ``tokens``
    inputs from the seed (normal, unit RMS as a normed hidden state, bf16)
    at the decode step's shape [tokens, 1, D]: its routed experts' output."""
    import torch
    from repro_torch.models import moe

    pc = program_config(cfg, fault)
    rng = np.random.default_rng(inputs.stream(seed, "experts-probe"))
    i = int(rng.integers(pc.first_dense_layers, pc.n_layers))
    params = model["moe_layers"][i - pc.first_dense_layers]["moe"]
    x = torch.from_numpy(rng.standard_normal((tokens, 1, pc.d_model), dtype=np.float32)).to(
        params["router"].device, torch.bfloat16)
    with torch.no_grad():
        y, _ = moe.moe_layer(params, x, top_k=pc.top_k, capacity_factor=pc.capacity_factor,
                             activation=pc.activation, norm_topk_prob=pc.norm_topk_prob,
                             dropless=pc.dropless)
    return {"layer": i, "x": x.reshape(tokens, -1), "y": y.reshape(tokens, -1)}


def run(run) -> None:
    with planted(run.traffic.get("fault")):
        prompt, served, probe = serve(run)
    check(run, prompt, served, probe)
    run.check("dropped_pairs", run.data["pairs_before_window"]["dropped"]
              + run.data["pairs"]["dropped"])


def serve(run):
    """Set-up and the window: (the prompts, the first round's served
    tokens, ``experts_probe``'s reading), the program freed."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.serve.serve_step import make_serve_steps

    cfg, tr, dev = run.config, run.traffic, run.device
    B, P, max_len = int(tr["batch"]), int(tr["prompt_len"]), int(tr["max_len"])
    group = int(tr["prefill_group"])
    prompt = prompts(run.seed, B, P)
    model = build_model(program_config(cfg, tr.get("fault")), device=dev)
    load_weights(model, cfg, run.seed, dev)
    run.mark("model and weights")
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)
    caches = model.init_decode_caches(B, max_len, device=dev)
    moe.count_pairs(dev)
    first = torch.empty((B, 1), dtype=torch.int32, device=dev)
    for lo in range(0, B, group):
        rows = slice(lo, min(B, lo + group))
        logits, pc = prefill_fn({"tokens": torch.from_numpy(prompt[rows]).to(dev)})
        _lay(caches, pc, rows)
        first[rows] = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        del logits, pc
    run.mark("prefill")

    rounds = [[first]]  # each round: the tokens served at P, P + 1, ...
    tok, pos = first, P

    def step():
        nonlocal tok, pos
        with span("pb.decode"):
            tok, _, _ = decode_fn(tok, caches, pos)
            if dev != "cpu":
                torch.cuda.synchronize()
        pos += 1
        if pos == max_len:  # the cache is full: start again after the prompts
            tok, pos = first, P
            rounds.append([first])
        else:
            rounds[-1].append(tok)

    for _ in range(int(tr["warmup_steps"])):
        step()
    setup_pairs = moe.pair_counts()
    moe.count_pairs(dev)
    run.mark("warm-up steps")
    lat, positions = [], []
    run.start_window()
    program = None
    if run.trace:
        from ..program_spans import ProgramTrace

        program = ProgramTrace()
        program.start()
    while True:
        positions.append(pos)
        t0 = time.perf_counter()
        step()
        lat.append(time.perf_counter() - t0)
        if run.expired():
            break
    run.stop_window()
    prof = run._prof  # noqa: SLF001  (the program's spans reduce the same trace)
    run.finish_trace()
    if program is not None:
        run.data["program"] = program.reduce(prof, run._w0_ns, run._w1_ns)  # noqa: SLF001
    del prof
    window_pairs = moe.pair_counts()
    if dev != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    probe = experts_probe(model, cfg, run.seed, B, tr.get("fault"))
    served = [torch.cat(r, dim=1).cpu().numpy() for r in rounds]
    del model, caches, prefill_fn, decode_fn, tok, first, rounds
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    run.attempted, run.failed = len(lat), len(run.errors)
    run.data.update(latencies_s=lat, positions=positions, batch=B,
                    served_tokens=int(sum(s.size for s in served)), pairs=window_pairs,
                    pairs_before_window=setup_pairs)
    return prompt, served[0], probe


def _experts_gap(dec, probe) -> float:
    """The relative gap (L2) of ``probe``'s routed experts to ``dec``'s
    over the same inputs."""
    h = probe["x"].float()
    ref = dec.experts(probe["layer"], h, *dec.route(probe["layer"], h))
    return float((probe["y"].float() - ref).norm() / ref.norm())


def check(run, prompt: np.ndarray, served: np.ndarray, probe: dict) -> None:
    import torch

    from ..reference import deepseek_v2

    tr, dev = run.traffic, run.device
    rng = np.random.default_rng(inputs.stream(run.seed, "decode-sample"))
    rows = np.sort(rng.choice(prompt.shape[0], int(tr["checked_sequences"]), replace=False))
    deepseek_v2.no_tf32()
    W = inputs_mla.weights(run.config, run.seed, dev)
    P = prompt.shape[1]
    seq = torch.from_numpy(np.concatenate([prompt[rows], served[rows][:, :-1]], axis=1)).to(dev)
    picked_ids = torch.from_numpy(served[rows]).long().to(dev)[..., None]
    with torch.no_grad():
        dec = deepseek_v2.Decoder(run.config, W)
        logits = dec.logits(seq, first=P - 1)
        best = logits.max(-1).values
        worst = float((best - logits.gather(-1, picked_ids)[..., 0]).max())
        experts_gap = _experts_gap(dec, probe)
        if tr.get("control"):
            # The control (not run by the benchmark's own runs): the
            # reference in fp8 in the program's place, read by the gap of
            # the token it puts first and by its routed experts' gap.
            dec8 = deepseek_v2.Decoder(run.config, W, precision="fp8")
            top = dec8.logits(seq, first=P - 1).argmax(-1)
            h = probe["x"].float()
            run.data["control"] = {
                "served_logit_gap": float((best - logits.gather(-1, top[..., None])[..., 0]).max()),
                "experts_gap": _experts_gap(dec, dict(
                    probe, y=dec8.experts(probe["layer"], h, *dec8.route(probe["layer"], h))))}
    del logits, W
    run.data["checked_tokens"] = int(len(rows) * served.shape[1])
    lat = sorted(run.data["latencies_s"])
    run.data["notes"] = {"checked_tokens": run.data["checked_tokens"], "steps": len(lat),
                         "step_ms_min_p50_max": [round(1e3 * lat[0], 3),
                                                 round(1e3 * lat[len(lat) // 2], 3),
                                                 round(1e3 * lat[-1], 3)],
                         "pairs_window": run.data["pairs"]}
    run.check("served_logit_gap", worst)
    run.check("experts_gap", experts_gap)
