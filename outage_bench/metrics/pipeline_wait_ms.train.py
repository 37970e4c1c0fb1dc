"""Host ms of DevicePipeline.batch's upload (span pipeline.upload: the
positions and date features copied from pageable memory, each copy
waiting for the stream) per train step."""

from outage_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "pipeline.upload")
