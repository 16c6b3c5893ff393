"""train_step_ms: the window, from the first step's start to a synchronize
after the last, over the steps (host clock)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.steps
