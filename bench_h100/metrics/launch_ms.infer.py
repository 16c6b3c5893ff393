"""launch_ms.infer: host milliseconds a request in the program's
``model.prep``, ``model.forward``, ``tta.views`` and ``tta.collapse``
spans, each stretch counted once: the host's time enqueueing the model's
device work."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(
        ctx, s.host_ms("model.prep", "model.forward", "tta.views", "tta.collapse"))
