"""95th percentile of the wait from an edit to its merged text, over every
sync sent in the window (end to end, host clock)."""

from dtbench.metrics import latencies_ms, quantile


def read(ctx):
    return quantile(latencies_ms(ctx), 0.95)
