"""Host ms of the serving engine's expansion (span engine.expansion:
4 ConvTranspose + pad + concat + DoubleConv levels, the 1x1 head and the
output reshape) per forward, mean over the traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "engine.expansion")
