"""Device ms of the serving engine's contraction per B=16 batch of the
sweep (the CUDA events of span engine.contraction), mean over the traced
segment's batches."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "engine.contraction")
