"""gate_ms.cascade: stream milliseconds a request across the cascade's
``cascade.gate`` spans (each chunk's QC and gate batches and the start of
their result's copy back), by their CUDA events."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.device_ms("cascade.gate"))
