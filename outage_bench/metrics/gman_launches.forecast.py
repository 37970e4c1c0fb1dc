"""Runtime calls that put work on the device (cudaLaunchKernel*,
cuLaunchKernel*, cudaMemcpyAsync, cudaMemsetAsync, and cudaGraphLaunch,
one call for a whole graph) started inside a gman.forward span (GMAN's
part of engine.st_gnn), per span."""

from outage_bench import spans

CALLS = spans.LAUNCHES + ("cudaGraphLaunch",)


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    within = spans.named(spans.program_spans(ctx.trace), "gman.forward")
    if not within:
        return None
    times = [s for n, s, _ in ctx.trace.host if n.startswith(CALLS)]
    return spans.starts_inside(times, spans.intervals(within)) / len(within)
