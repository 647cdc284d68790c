"""Zone session: X8's share of its HBM roofline in the traced window, in %:
the bytes its launches must move at least (`dtbench/roofline_zone.py`, from
the window's difference of the program's `zone` launch-shape counters) at
the card's HBM rate, over the kernel's device time in the trace. None from
a program that counts no launch shapes, or with no X8 time traced."""

from dtbench.metrics import kernel_s
from dtbench.roofline_zone import (HBM_BYTES_PER_S, zone_bytes_from_counts,
                                   zone_delta)


def read(ctx):
    z = zone_delta(ctx)
    s = kernel_s(ctx, "zone_tape_kernel")
    if z is None or not s or z["launches"] == 0:
        return None
    return 100.0 * zone_bytes_from_counts(z) / HBM_BYTES_PER_S / s
