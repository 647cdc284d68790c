"""The scheduler, admit to commit: the 95th percentile of its
`latencies.queue_wait` over the window. serve/scheduler.py records it when
the flush ends, so it spans the wait in the queue and the flush; read from
its log2 buckets, interpolated as obs/hist.py does."""

from dtbench.metrics import hist_quantile, hist_window


def read(ctx):
    q = hist_quantile(hist_window(ctx["sched_before"], ctx["sched_after"],
                                  "queue_wait"), 0.95)
    return None if q is None else 1e3 * q
