"""Kernel 1 (DoubleConv, csrc/double_conv.cu): % of the summed bounds of a
forward's DoubleConvs (5 in the contraction, 4 in the expansion), one
launch each."""

from outage_bench import counts, readers

PATTERNS = ("double_conv_kernel",)


def read(ctx):
    shapes = counts.double_conv_shapes(ctx.model, ctx.data["image_size"])
    return readers.kernel_roofline(ctx, PATTERNS, lambda: readers.double_conv_bound(ctx),
                                   len(shapes))
