"""augment_ms.train: device time of the call into ``augment_step`` a step,
by CUDA events the benchmark places around it."""


def read(ctx):
    times = ctx.entry.augment_ms(ctx.steps)
    return sum(times) / len(times) if times else None
