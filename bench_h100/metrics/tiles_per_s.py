"""tiles_per_s: tiles whose results are on the host in the window, over the
window's seconds (host clock)."""


def read(ctx):
    return ctx.tiles / ctx.window_s
