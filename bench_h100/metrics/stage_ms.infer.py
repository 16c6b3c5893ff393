"""stage_ms.infer: host milliseconds a request in the program's
``entry.h2d`` spans: staging the tiles for the copy to the card (a
pageable copy, or pinning and an asynchronous copy)."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.host_ms("entry.h2d"))
