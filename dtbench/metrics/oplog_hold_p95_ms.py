"""Bank flush, the oplog lock held: the 95th percentile of the window's
holds (`latencies.oplog_hold`, one sample a hold, at the flush's three
acquisitions), from its log2 buckets as obs/hist.py interpolates. None from
a program that keeps no such histogram."""

from dtbench.phases import window_quantile_ms


def read(ctx):
    return window_quantile_ms(ctx, "oplog_hold", 0.95)
