"""The window over the number of complete group calls."""


def read(ctx):
    return ctx.window_s / ctx.calls * 1e3
