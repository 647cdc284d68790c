"""Zone session: the share of the window's continued zone syncs whose
micro-tape the C++ composer and packer built, in % (the scheduler's `zone`
counters: prep_native over prep_native + prep_python). None from a program
that keeps no such counters, or with no continued sync in the window."""

from dtbench.roofline_zone import zone_delta


def read(ctx):
    z = zone_delta(ctx)
    if z is None or "prep_native" not in z:
        return None
    built = z["prep_native"] + z["prep_python"]
    if built == 0:
        return None
    return 100.0 * z["prep_native"] / built
