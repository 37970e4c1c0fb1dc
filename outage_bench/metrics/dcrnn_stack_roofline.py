"""Kernel 5 (the whole DCRNN seq2seq, csrc/dcrnn_stack.cu): % of its bound
per forward, one launch a forward."""

from outage_bench import counts, readers

PATTERNS = ("dcrnn_stack_kernel",)


def read(ctx):
    b, n, t, _ = ctx.shape
    bound = lambda: counts.bound_s(*counts.dcrnn_stack_counts(
        ctx.model, b, n, t, ctx.data["horizon"], ctx.n_static, 2), ctx.peaks)
    return readers.kernel_roofline(ctx, PATTERNS, bound, 1)
