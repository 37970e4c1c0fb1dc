"""The whole forward's (or train step's) share of the card's bf16 dense
peak over the measured window, its operations counted over the plain
reference."""

from outage_bench import readers


def read(ctx):
    return readers.mfu(ctx)
