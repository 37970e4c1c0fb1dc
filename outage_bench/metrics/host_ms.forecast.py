"""Host ms from the call into ServingModel.__call__ to its return, mean over
the window's requests (a span the harness keeps around the call)."""

from outage_bench import readers


def read(ctx):
    return readers.mean_span(ctx, "host_ms")
