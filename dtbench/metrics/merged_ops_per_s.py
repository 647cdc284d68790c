"""Ops of every sync committed in the window, over the window's seconds:
what one card merges for its documents (end to end, host clock)."""

from dtbench.metrics import committed_in_window


def read(ctx):
    return sum(s.n_ops for s in committed_in_window(ctx)) / ctx["window_s"]
