"""Device ms of GMAN's decoder per forward (the CUDA events of span
gman.decoder, inside engine.st_gnn: the 3 decoder ST-Attention blocks and
the output FC), mean over the traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "gman.decoder")
