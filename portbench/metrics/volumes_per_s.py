"""Volumes completed over the whole window, by the host clock."""


def read(ctx):
    return ctx.units / ctx.window_s
