"""The 95th percentile of every decode step of the window, each timed to
``torch.cuda.synchronize()``."""

from portbench.harness import quantile


def read(run):
    lat = run.data["latencies_s"]
    return quantile(lat, 0.95) * 1e3 if lat else None
