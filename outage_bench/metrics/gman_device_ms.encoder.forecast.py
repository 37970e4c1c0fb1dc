"""Device ms of GMAN's encoder per forward (the CUDA events of span
gman.encoder, inside engine.st_gnn: the input FC and the 3 encoder
ST-Attention blocks), mean over the traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "gman.encoder")
