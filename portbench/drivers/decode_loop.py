"""Greedy decode of a batch of sequences in lockstep. Set-up draws the
prompts from the seeded corpus, prefills them through the program's
prefill step in groups, lays the caches into one decode cache of
``max_len`` positions, and runs a few decode steps. The window then runs
``make_serve_steps``' decode step until it closes, each step timed to
``torch.cuda.synchronize()``; when the cache is full the next round starts
again from the prefilled positions (that restart is not a step).

After the window the program is freed and the reference runs one full
forward over the prompt and served tokens of a sample of the sequences,
drawn from the seed: the widest gap by which a served token's logit lies
below the reference's best at its position is compared."""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import inputs
from ..harness import span
from .decoder_common import SMALL_MODEL, load_weights, program_config


def small(cfg, tr):
    """The cell's configuration and traffic at the host tests' size."""
    return (dict(cfg, **SMALL_MODEL),
            dict(tr, batch=4, prompt_len=24, max_len=40, prefill_group=2, checked_sequences=2))


def control(manifest, cell, cfg, tr, seed: int, *, device: str, seconds: float, **_) -> dict:
    """The program's decode for a short window, then the reference in fp8
    read at each served position by the gap of the token it puts first."""
    from .. import harness

    run = harness.run_cell(manifest, cell, seed=seed, seconds=seconds, trace=False,
                           device=device, t_start=time.monotonic(), config=cfg,
                           traffic=dict(tr, control=True))
    return {"fp8": run.data["control"], "program": {k: v["value"] for k, v in run.checks.items()},
            "checked_tokens": run.data["checked_tokens"]}


def prompts(seed: int, batch: int, length: int) -> np.ndarray:
    """``batch`` prompts of ``length`` byte tokens of the seeded corpus."""
    text = inputs.base64_text(inputs.stream(seed, "prompts"), batch * length)
    return np.frombuffer(text, np.uint8).astype(np.int32).reshape(batch, length)


def _lay(dst, src, rows: slice) -> None:
    """Prefill caches ``src`` ([L, g, P, ...]) into rows of the decode
    caches ``dst`` ([L, B, max_len, ...]), leaf by leaf."""
    if isinstance(dst, dict):
        for k, v in src.items():
            _lay(dst[k], v, rows)
        return
    dst[:, rows, : src.shape[2]].copy_(src)


def run(run) -> None:
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve.serve_step import make_serve_steps

    cfg, tr, dev = run.config, run.traffic, run.device
    B, P, max_len = int(tr["batch"]), int(tr["prompt_len"]), int(tr["max_len"])
    group = int(tr["prefill_group"])
    prompt = prompts(run.seed, B, P)
    model = build_model(program_config(cfg), device=dev)
    W = inputs.decoder_weights(cfg, run.seed, dev)
    load_weights(model, W)
    del W
    run.mark("model and weights")
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=max_len)
    caches = model.init_decode_caches(B, max_len, device=dev)
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
    run.mark("warm-up steps")
    lat, positions = [], []
    run.start_window()
    while True:
        positions.append(pos)
        t0 = time.perf_counter()
        step()
        lat.append(time.perf_counter() - t0)
        if run.expired():
            break
    run.stop_window()
    run.finish_trace()
    if dev != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    served = [torch.cat(r, dim=1).cpu().numpy() for r in rounds]
    del model, caches, prefill_fn, decode_fn, tok, first, rounds
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    run.attempted, run.failed = len(lat), len(run.errors)
    run.data.update(latencies_s=lat, positions=positions, batch=B,
                    served_tokens=int(sum(s.size for s in served)))
    check(run, prompt, served[0])


def check(run, prompt: np.ndarray, served: np.ndarray) -> None:
    import torch

    from ..reference import granite

    tr, dev = run.traffic, run.device
    rng = np.random.default_rng(inputs.stream(run.seed, "decode-sample"))
    rows = np.sort(rng.choice(prompt.shape[0], int(tr["checked_sequences"]), replace=False))
    granite.no_tf32()
    W = inputs.decoder_weights(run.config, run.seed, dev)
    ref = granite.Decoder(run.config, W, precision="bf16")
    # The control (not run by the benchmark's own runs): the reference in
    # fp8 in the program's place, read by the gap of the token it puts first.
    control = granite.Decoder(run.config, W, precision="fp8") if tr.get("control") else None
    worst = worst_control = 0.0
    P = prompt.shape[1]
    with torch.no_grad():
        for r in rows:
            seq = torch.from_numpy(np.concatenate([prompt[r], served[r][:-1]]))[None].to(dev)
            logits = ref.logits(seq)[0, P - 1 :].float()
            best = logits.max(-1).values
            picked = logits.gather(-1, torch.from_numpy(served[r]).long().to(dev)[:, None])[:, 0]
            worst = max(worst, float((best - picked).max()))
            if control is not None:
                first = control.logits(seq)[0, P - 1 :].argmax(-1)
                gap = best - logits.gather(-1, first[:, None])[:, 0]
                worst_control = max(worst_control, float(gap.max()))
            del logits
    del ref, control, W
    run.data["checked_tokens"] = int(len(rows) * served.shape[1])
    lat = sorted(run.data["latencies_s"])
    run.data["notes"] = {"checked_tokens": run.data["checked_tokens"], "steps": len(lat),
                         "step_ms_min_p50_max": [round(1e3 * lat[0], 3),
                                                 round(1e3 * lat[len(lat) // 2], 3),
                                                 round(1e3 * lat[-1], 3)]}
    if tr.get("control"):
        run.data["control"] = {"served_logit_gap": worst_control}
    run.check("served_logit_gap", worst)
