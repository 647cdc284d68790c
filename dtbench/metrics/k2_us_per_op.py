"""Device plan: K2's device time (csrc/xform_positions.cu, by kernel name
in the trace) per op merged in the traced window."""

from dtbench.metrics import us_per_merged_op


def read(ctx):
    return us_per_merged_op(ctx, "xform_rows_kernel")
