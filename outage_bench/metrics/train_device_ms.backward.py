"""Device ms of the train step's backward (the CUDA events of span
train.backward, around loss.backward()) per step."""

from outage_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.backward")
