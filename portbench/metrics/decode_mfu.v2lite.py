"""The DeepSeek-V2 decode steps' least time on the card over their measured
time: each step's least time is the larger of its FLOPs (every active
weight twice a token, absorbed latent attention up to the step's
position) over the bf16 peak and its bytes (every weight, all routed
experts included, the latent cache up to the position, the new latents
and the logits) over HBM bandwidth, counted by ``arith_mla``."""

from portbench import arith_mla


def read(run):
    b = int(run.data["batch"])
    least = sum(arith_mla.decode_step_least_s(run.config, b, p) for p in run.data["positions"])
    return 100.0 * least / run.window_s
