"""Device ms of DevicePipeline.batch per step, CUDA events around the call,
mean over the window's steps (a span the harness keeps)."""

from outage_bench import readers


def read(ctx):
    return readers.mean_span(ctx, "input_ms")
