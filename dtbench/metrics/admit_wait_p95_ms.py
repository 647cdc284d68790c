"""The scheduler's queue, admit to flush start: the 95th percentile of the
window's `latencies.admit_wait` (recorded per item when its flush starts),
from its log2 buckets as obs/hist.py interpolates. None from a program that
keeps no such histogram."""

from dtbench.phases import window_quantile_ms


def read(ctx):
    return window_quantile_ms(ctx, "admit_wait", 0.95)
