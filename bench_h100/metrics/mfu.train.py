"""mfu.train: forward and backward FLOPs (three forwards, recompute not
counted) of every step of the traced window, over its seconds and the bf16
peak, in percent."""

from bench_h100.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.steps * ctx.entry.flops_per_step)
