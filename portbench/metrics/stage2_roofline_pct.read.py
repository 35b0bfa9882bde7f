"""Stage 2's share of its roofline: the bytes of every stage-2 launch of
the window (the engine's launch shapes, counted by the benchmark's frozen
arithmetic: each input byte read once, each output byte written once)
over HBM bandwidth, against the device time of the two kernels in the
profiler's trace."""

from portbench import arith

KERNELS = ("marker_replace", "crc32")


def read(run):
    t = run.trace_summary
    if t is None:
        return None
    secs = sum(v for name, v in t["kernels"].items() if any(k in name for k in KERNELS))
    nbytes = arith.stage2_bytes(run.data["shapes"])
    if secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / arith.HBM_BYTES_PER_S / secs
