"""Device ms of the train step's Adam update (the CUDA events of span
train.optimizer) per step."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.optimizer")
