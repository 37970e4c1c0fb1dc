"""Device ms of the train step's forward and loss (the CUDA events of
span train.forward) per step."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.forward")
