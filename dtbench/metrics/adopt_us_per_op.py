"""Bank flush, adoption: the `adopt` phase (the fenced rows committed,
syncs counted, failed rows evicted; the per-doc rung aside), in
microseconds per op committed in the window. It is the window's
delta of the scheduler's `flush_phases.seconds.adopt` over the ops of
every sync committed in it: wall time on the flushing threads, summed over
shards. None from a program that keeps no phases."""

from dtbench.phases import phase_us_per_op


def read(ctx):
    return phase_us_per_op(ctx, "adopt")
