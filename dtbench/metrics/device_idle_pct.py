"""Device: the share of the traced window, in %, with no kernel, copy or
set on the card (the union of the profiler's device events)."""

from dtbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
