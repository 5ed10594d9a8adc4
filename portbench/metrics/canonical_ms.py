"""Host milliseconds inside the stage timer's "stage:canonical" ranges
(which synchronize, so they hold the stage's device work), per volume."""


def read(ctx):
    if ctx.trace is None or "stage:canonical" not in ctx.trace.ranges:
        return None
    return ctx.trace.range_s("stage:canonical") * 1e3 / ctx.units
