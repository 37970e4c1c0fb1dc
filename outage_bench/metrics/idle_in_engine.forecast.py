"""% of the traced window in which the device idled while the host was
inside ServingModel.__call__ (spans engine.forward; idle = no kernel,
copy or set running, overlaps counted once)."""

from outage_bench import spans


def read(ctx):
    return spans.idle_in(ctx, "engine.forward")
