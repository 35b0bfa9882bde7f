"""The share of the window spent in ``next()`` on the corpus pipeline's
iterator (the benchmark's own span around each call)."""


def read(run):
    return 100.0 * run.data["data_wait_s"] / run.window_s
