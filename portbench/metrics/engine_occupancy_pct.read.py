"""The stage-2 engine's tiles dispatched over tiles dispatched and padded,
over the window (``TorchDecodeEngine.stats()``)."""


def read(run):
    e = run.data["engine"]
    total = e["tiles_dispatched"] + e["tiles_padded"]
    return 100.0 * e["tiles_dispatched"] / total if total else None
