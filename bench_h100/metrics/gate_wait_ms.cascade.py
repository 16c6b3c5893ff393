"""gate_wait_ms.cascade: host milliseconds a request in the cascade's
``cascade.gate_wait`` spans: the host's wait for each chunk's QC and gate
result, which picks the tiles the U-Net segments."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.host_ms("cascade.gate_wait"))
