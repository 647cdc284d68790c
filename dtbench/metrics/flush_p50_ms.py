"""Bank flush (plan + replay + fence) median over the window, from the
scheduler's bucketed `latencies.flush` histogram."""

from dtbench.metrics import hist_quantile, hist_window


def read(ctx):
    q = hist_quantile(hist_window(ctx["sched_before"], ctx["sched_after"],
                                  "flush"), 0.5)
    return None if q is None else 1e3 * q
