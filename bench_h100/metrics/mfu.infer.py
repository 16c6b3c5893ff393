"""mfu.infer: forward FLOPs of every tile completed in the traced window,
over its seconds and the bf16 peak, in percent."""

from bench_h100.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.tiles * ctx.entry.flops_per_tile)
