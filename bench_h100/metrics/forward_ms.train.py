"""forward_ms.train: device milliseconds a step of the program's
``train.forward`` spans, by their CUDA events."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.device_ms("train.forward"))
