"""Host milliseconds inside the "span:read" ranges (the reads of the
group's .key files), per group call."""


def read(ctx):
    if ctx.trace is None or "span:read" not in ctx.trace.ranges:
        return None
    return ctx.trace.range_s("span:read") * 1e3 / ctx.calls
