"""request_p95_ms: the 95th percentile of every request of the window, each
timed from the call into the entry to its result on the host (host clock)."""

from bench_h100.readers import p95_ms


def read(ctx):
    return p95_ms(ctx)
