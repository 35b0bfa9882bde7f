"""Model FLOPs of the window's steps (PaLM's appendix B, counted from the
configuration's shapes by the benchmark's frozen arithmetic, remat's
recompute not counted) over the window, as a share of the bf16 peak."""

from portbench import arith


def read(run):
    seq = int(run.traffic["seq_len"])
    flops = run.data["tokens"] * arith.train_flops_per_token(run.config, seq)
    return 100.0 * flops / run.window_s / arith.PEAK_BF16_FLOPS
