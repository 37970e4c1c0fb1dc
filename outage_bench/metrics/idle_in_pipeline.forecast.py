"""% of the traced window in which the device idled while the host was
inside DevicePipeline.batch (spans pipeline.batch: the window gather and
its blocking upload)."""

from outage_bench import spans


def read(ctx):
    return spans.idle_in(ctx, "pipeline.batch")
