"""forward_ms.infer: stream milliseconds a request across the program's
``model.forward`` spans, by their CUDA events: the device's work, and at
batch 1 also its waits for the host's launches inside the forward."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.device_ms("model.forward"))
