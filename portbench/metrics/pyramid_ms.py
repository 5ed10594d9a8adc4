"""Host milliseconds inside the "stage:initial_blur" and "stage:pyramid"
ranges, per volume."""


def read(ctx):
    if ctx.trace is None or "stage:pyramid" not in ctx.trace.ranges:
        return None
    return ctx.trace.range_s("stage:initial_blur", "stage:pyramid") * 1e3 / ctx.units
