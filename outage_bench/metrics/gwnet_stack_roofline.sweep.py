"""Kernel 2 (the whole eval-mode Graph WaveNet stack, csrc/gwnet_stack.cu)
in the sweep: % of its bound per B=16 forward, one launch a forward, over
the static and the adaptive supports."""

from outage_bench import counts, readers

PATTERNS = ("gwnet_stack_kernel",)


def read(ctx):
    b, n, t, _ = ctx.shape
    s = ctx.n_static + int(ctx.model["gwnet"]["addaptadj"])
    bound = lambda: counts.bound_s(*counts.gwnet_stack_counts(ctx.model, b, n, t, s, 2),
                                   ctx.peaks)
    return readers.kernel_roofline(ctx, PATTERNS, bound, 1)
