"""Host milliseconds inside the "span:hough" ranges (around
``match_keys_stacked(..., refine=True)``), per group call."""


def read(ctx):
    if ctx.trace is None or "span:hough" not in ctx.trace.ranges:
        return None
    return ctx.trace.range_s("span:hough") * 1e3 / ctx.calls
