"""Device plan: the share of planned documents whose tails K2 resolved in
the window, in % (the scheduler's `transform` counters: device_docs over
device_docs + host_docs + fallbacks)."""

from dtbench.metrics import transform_delta


def read(ctx):
    dev = transform_delta(ctx, "device_docs")
    total = dev + transform_delta(ctx, "host_docs") \
        + transform_delta(ctx, "fallbacks")
    return None if total == 0 else 100.0 * dev / total
