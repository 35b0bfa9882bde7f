"""A closed loop of training steps. Set-up builds one train step (the
program's model, ``make_train_step`` and AdamW state) and one
``GzipCorpusDataset`` over gzip shards of base64 text, drives the step
through its first ``checked_steps`` steps on the dataset's batches, and
hands the same objects to the window, which steps until it closes.

After the window the program is freed and the reference, from the same
seed, rebuilds every batch from the shards' text (each compared token for
token with what the program consumed) and follows the first steps: the
first step's loss, each leaf's first gradient as the optimizer took it
(the program's worked out from its first moment after one step; the
worst leaf) and each leaf's change after the checked steps (the median
leaf), by their norms, are compared."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from .. import inputs
from ..harness import span
from ..reference import tokens as ref_tokens
from .decoder_common import (SMALL_MODEL, leaf_gaps, load_weights, median_gap, moved_leaves,
                             named_leaves, norm_gap, program_config)


def small(cfg, tr):
    """The cell's configuration and traffic at the host tests' size."""
    return (dict(cfg, **SMALL_MODEL),
            dict(tr, batch=2, seq_len=40, shard_bytes=20_000, chunk_size=16 << 10))


def adamw_config(opt):
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(peak_lr=opt["peak_lr"], end_lr_fraction=opt["end_lr_fraction"],
                       warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                       b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                       weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])


def shard_texts(seed: int, traffic) -> list:
    """The text of each of the mix's shards, from the seed."""
    return [inputs.base64_text(inputs.stream(seed, "shard", i), int(traffic["shard_bytes"]))
            for i in range(int(traffic["shards"]))]


def run(run) -> None:
    import torch
    from repro_torch.data.pipeline import GzipCorpusDataset
    from repro_torch.kernels.engine import TorchDecodeEngine
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg, tr = run.config, run.traffic
    opt_spec = tr["optimizer"]
    dev = run.device
    B, S, checked = int(tr["batch"]), int(tr["seq_len"]), int(tr["checked_steps"])
    texts = shard_texts(run.seed, tr)
    paths = [str(run.write_scratch("shard%d.gz" % i, inputs.gzip_member(t, int(tr["gzip_level"]))))
             for i, t in enumerate(texts)]
    engine = TorchDecodeEngine(device=dev)
    run.mark("shards, engine and kernels")
    consumed, losses = [], []
    try:
        model = build_model(program_config(cfg), device=dev)
        W = inputs.decoder_weights(cfg, run.seed, dev)
        load_weights(model, W)
        del W
        run.mark("model and weights")
        step = make_train_step(model, adamw_config(opt_spec))
        params = model.param_tree()
        opt = init_opt_state(params)
        data = GzipCorpusDataset(paths, seq_len=S, batch_size=B,
                                 parallelization=int(tr["parallelization"]),
                                 chunk_size=int(tr["chunk_size"]), loop=True, resolver=engine)
        it = iter(data)

        def one_step():
            nonlocal params, opt
            with span("pb.next_batch"):
                batch = next(it)
            t_data = time.monotonic()
            with span("pb.step"):
                params, opt, metrics = step(params, opt, batch)
                loss = float(metrics["loss"])
                if dev != "cpu":
                    torch.cuda.synchronize()
            consumed.append(batch["tokens"].copy())
            losses.append(loss)
            if not math.isfinite(loss):
                run.errors.append("step %d: loss %r" % (len(losses), loss))
            return t_data

        # The first steps, which the reference follows; they warm every shape.
        grad_first = change = None
        for s in range(1, checked + 1):
            one_step()
            if s == 1:
                b1 = float(opt_spec["b1"])
                grad_first = {n: float(m.norm() / (1 - b1))
                              for n, m in named_leaves(opt["m"]).items()}
        run.mark("checked steps")
        W0 = inputs.decoder_weights(cfg, run.seed, dev)
        with torch.no_grad():
            change = {}
            for n, p in named_leaves(params).items():
                w0 = W0[n] if not n.startswith("layers.") else \
                    W0[n.split(".")[2]][int(n.split(".")[1])]
                change[n] = float((p.float() - w0.float()).norm())
        del W0
        if dev != "cpu":
            torch.cuda.synchronize()

        wait = 0.0
        steps = 0
        run.start_window()
        while True:
            t0 = time.monotonic()
            wait += one_step() - t0
            steps += 1
            if run.expired():
                break
        run.stop_window()
        run.finish_trace()
        if dev != "cpu":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        data.close()
        del model, params, opt, step, data, it
    finally:
        engine.shutdown()
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    run.attempted, run.failed = steps, len(run.errors)
    run.data.update(steps=steps, tokens=steps * B * S, data_wait_s=wait, losses=losses)
    check(run, texts, consumed, losses[:checked], grad_first, change)


def check(run, texts, consumed, losses, grad_first, change) -> None:
    """The reference after the window: batches, then the first steps."""
    import torch

    from ..reference import granite

    tr, dev = run.traffic, run.device
    B, S, checked = int(tr["batch"]), int(tr["seq_len"]), int(tr["checked_steps"])
    want = ref_tokens.batches(texts, B, S, len(consumed))
    got = np.stack(consumed)
    run.check("batch_token_mismatch", int(np.count_nonzero(want != got)))

    granite.no_tf32()
    W = inputs.decoder_weights(run.config, run.seed, dev)
    model = granite.Decoder(run.config, W, precision="bf16")
    batches = [torch.from_numpy(want[i]).to(dev) for i in range(checked)]
    ref = granite.train(model, batches, tr["optimizer"])
    del model, W, batches
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    keep = moved_leaves(ref["grad_norms"])
    worst = max(leaf_gaps(change, ref["change_norms"], keep).items(), key=lambda kv: kv[1])
    run.data["notes"] = {"losses": losses, "reference_losses": ref["losses"],
                         "leaves_compared": "%d of %d" % (len(keep), len(ref["grad_norms"])),
                         "change_gap_worst_leaf": worst}
    # The first step's loss only: the later steps' losses follow the first
    # updates, which amplify bf16 rounding from seed to seed; the updates
    # themselves are compared by the two norms below.
    run.check("first_loss_gap", abs(losses[0] - ref["losses"][0]))
    run.check("grad_norm_gap", norm_gap(grad_first, ref["grad_norms"], keep))
    # The median leaf's change: the worst leaf's follows the later steps'
    # gradients, which part from seed to seed as the losses do.
    run.check("change_gap_median_leaf", median_gap(change, ref["change_norms"], keep))


def control(manifest, cell, cfg, tr, seed: int, *, device: str, **_) -> dict:
    """The reference in fp8 in the program's place, and the reference with
    half of each batch left out (the mean taken over the rest), each
    against the reference, by the numbers the cell compares."""
    import torch

    from ..reference import granite

    B, S, checked = int(tr["batch"]), int(tr["seq_len"]), int(tr["checked_steps"])
    want = ref_tokens.batches(shard_texts(seed, tr), B, S, checked)
    granite.no_tf32()

    def follow(precision: str, rows: int) -> dict:
        W = inputs.decoder_weights(cfg, seed, device)
        batches = [torch.from_numpy(want[i][:rows]).to(device) for i in range(checked)]
        out = granite.train(granite.Decoder(cfg, W, precision=precision), batches,
                            tr["optimizer"])
        del W, batches
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        return out

    ref = follow("bf16", B)
    keep = moved_leaves(ref["grad_norms"])
    readings = {}
    for name, other in (("fp8", follow("fp8", B)), ("half_batch", follow("bf16", B // 2))):
        readings[name] = {
            "first_loss_gap": abs(other["losses"][0] - ref["losses"][0]),
            "loss_gaps": [abs(a - b) for a, b in zip(other["losses"], ref["losses"])],
            "grad_norm_gap": norm_gap(other["grad_norms"], ref["grad_norms"], keep),
            "change_norm_gap": norm_gap(other["change_norms"], ref["change_norms"], keep),
            "change_gap_median_leaf": median_gap(other["change_norms"], ref["change_norms"],
                                                 keep)}
    return readings
