"""Tokens of every optimizer step completed in the window, over the
window (which ends when the step that passed its length completes)."""


def read(run):
    return run.data["tokens"] / run.window_s
