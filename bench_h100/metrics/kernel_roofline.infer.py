"""kernel_roofline.infer: the port's kernels' bound from shapes over their
device time, weighted by time, over the launches the profiler recorded."""

from bench_h100.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx)
