"""Host ms of the serving engine's contraction (span engine.contraction:
the input cast, 5 DoubleConvs and 4 max-pools) per forward, mean over the
traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "engine.contraction")
