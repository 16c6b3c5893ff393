"""blend_ms.cascade: stream milliseconds a request across the cascade's
``cascade.blend`` spans (each chunk's canvases, each batch's weighted
accumulation and the stripes it finalizes), by their CUDA events."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.device_ms("cascade.blend"))
