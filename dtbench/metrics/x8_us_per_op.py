"""Zone session: X8's device time (csrc/zone_tape.cu, `zone_tape_kernel` by
name in the trace) per op merged in the traced window."""

from dtbench.metrics import us_per_merged_op


def read(ctx):
    return us_per_merged_op(ctx, "zone_tape_kernel")
