"""Residency tier: the mean load of a document's home (`TieredStore.load`:
its pages read and decoded into a fresh OpLog), in ms: the window's delta
of `residency.load_s` over its delta of `residency.loads`. None from a
program without the residency block, or with no load in the window."""

from dtbench.residency import window_delta


def read(ctx):
    s = window_delta(ctx, "residency", "load_s")
    n = window_delta(ctx, "residency", "loads")
    if s is None or not n:
        return None
    return 1e3 * s / n
