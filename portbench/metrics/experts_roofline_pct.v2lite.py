"""The routed experts' share of their roofline: the bytes of the window's
grouped products (each MoE layer of each step: every routed expert's gate,
up and down weights, each token-slot pair's activation in and out,
counted by ``arith_mla``) over HBM bandwidth, against the device seconds
of the kernels launched inside the program's ``moe.experts`` spans (the
sort, the grouped products and the combine). None where the program
records no such span or the ring dropped one."""

from portbench import arith, arith_mla


def read(run):
    t = run.data.get("program")
    if t is None or t["program_spans_dropped"]:
        return None
    secs = t["device_by_span"].get("moe.experts")
    if not secs:
        return None
    pairs = int(run.data["batch"]) * int(run.config["num_experts_per_tok"])
    calls = len(run.data["positions"]) * arith_mla.moe_layers(run.config)
    nbytes = calls * arith_mla.expert_products_bytes(run.config, pairs)
    return 100.0 * nbytes / arith.HBM_BYTES_PER_S / secs
