"""prep_ms.infer: stream milliseconds a request across the program's
``model.prep`` and ``tta.views`` spans (D, P and the resize of the TTA
request), by their CUDA events. Read in the TTA cell, where the device
works through the views while the host enqueues them; before the U-Net's
kernel A the device is idle, so there the events would time A's launch."""

from bench_h100 import spans


def read(ctx):
    s = spans.load()
    return None if s is None else spans.per_unit(ctx, s.device_ms("model.prep", "tta.views"))
