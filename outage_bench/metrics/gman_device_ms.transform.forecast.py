"""Device ms of GMAN's transform attention per forward (the CUDA events
of span gman.transform, inside engine.st_gnn: the 7 future days over the
7 past days, and its FCs), mean over the traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "gman.transform")
