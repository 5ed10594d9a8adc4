"""1 - (the union of the device's kernel, copy and set intervals) / (the
traced window), averaged over the cell's cards."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s(ctx.devices or [0]) / ctx.trace.window_s
