"""idle_pct.infer: share of the traced window in which no kernel, copy or set
ran on the device, in percent."""

from bench_h100.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
