"""Host milliseconds inside the program's "stage:refine" spans (every pair's
transform and its --refine solve, in ``match/pairwise.py``), per group
call."""


def read(ctx):
    if ctx.trace is None or "stage:refine" not in ctx.trace.ranges or not ctx.calls:
        return None
    return ctx.trace.range_s("stage:refine") * 1e3 / ctx.calls
