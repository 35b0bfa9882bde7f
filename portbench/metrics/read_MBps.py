"""Decompressed bytes of the window's whole cold reads over the window
(whole passes over the file), in MB/s (1e6 bytes)."""


def read(run):
    return run.data["bytes"] / run.window_s / 1e6
