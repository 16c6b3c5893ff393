"""segment_fill.cascade: the positive tiles over the U-Net's batch slots
(padding included), in percent: the program's ``cascade.positive_tiles``
and ``cascade.segment_slots`` counters."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    if s is None:
        return None
    positive, slots = s.counter("cascade.positive_tiles"), s.counter("cascade.segment_slots")
    return None if positive is None or not slots else 100.0 * positive / slots
