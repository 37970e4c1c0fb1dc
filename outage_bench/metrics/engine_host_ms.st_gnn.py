"""Host ms of the serving engine's st-GNN (span engine.st_gnn: one
kernel launch for Graph WaveNet or DCRNN) per forward, mean over the
traced segment's forwards."""

from outage_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "engine.st_gnn")
