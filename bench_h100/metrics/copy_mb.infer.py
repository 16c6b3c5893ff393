"""copy_mb.infer: megabytes a request that the program copies to the card
and back (its ``h2d_bytes`` and ``d2h_bytes`` counters)."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    total = None if s is None else s.counter("h2d_bytes", "d2h_bytes")
    return spans.per_unit(ctx, None if total is None else total / 1e6)
