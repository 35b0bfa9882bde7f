"""The decode steps' least time on the card over their measured time: each
step's least time is the larger of its FLOPs over the bf16 peak and its
bytes (the weights read once, each sequence's cache read up to its
position, the new keys, values and logits written) over HBM bandwidth,
counted by the benchmark's frozen arithmetic."""

from portbench import arith


def read(run):
    b = int(run.data["batch"])
    least = sum(arith.decode_step_least_s(run.config, b, p) for p in run.data["positions"])
    return 100.0 * least / run.window_s
