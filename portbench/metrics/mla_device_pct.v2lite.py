"""Latent attention's share of the device: 100 x the device seconds of the
kernels launched inside the program's ``mla.attend`` spans (scores,
softmax and values, with the cache write and the absorbed projections)
over the device's busy seconds in the window (``program_spans``). None
where the program records no such span or the ring dropped one."""


def read(run):
    t = run.data.get("program")
    if t is None or t["program_spans_dropped"] or t["busy_s"] <= 0:
        return None
    secs = t["device_by_span"].get("mla.attend")
    return 100.0 * secs / t["busy_s"] if secs else None
