"""conv_share.infer: device time of the convolutions over the busy time, in
percent, from the profiler."""

from bench_h100.readers import conv_share


def read(ctx):
    return conv_share(ctx)
