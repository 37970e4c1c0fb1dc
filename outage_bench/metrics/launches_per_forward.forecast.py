"""Runtime calls that put work on the device (cudaLaunchKernel*,
cuLaunchKernel*, cudaMemcpyAsync, cudaMemsetAsync) started inside an
engine.forward span, per span."""

from outage_bench import spans


def read(ctx):
    return spans.launches_per(ctx, "engine.forward")
