"""host_self_ms.infer: host milliseconds a request in the program's
outermost request spans (``segment.batch``, ``tta.predict``) outside their
child spans: the pad, the slice, the copy back and the wait for the device
that it holds."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.host_self_ms("segment.batch",
                                                                      "tta.predict"))
