"""setup_s: process start to the first timed request or step, host clock."""


def read(ctx):
    return ctx.setup_s
