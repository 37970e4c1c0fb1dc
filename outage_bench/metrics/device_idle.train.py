"""% of the traced window in which no kernel, copy or set ran on the
device (the union of their intervals, so overlaps count once)."""

from outage_bench import readers


def read(ctx):
    return readers.device_idle(ctx)
