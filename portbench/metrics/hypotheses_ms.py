"""Host milliseconds inside the program's "stage:hough_hypotheses" spans
(the stacking of every pair's matches and their transform hypotheses, in
``match/hough.py``), per group call."""


def read(ctx):
    if ctx.trace is None or "stage:hough_hypotheses" not in ctx.trace.ranges or not ctx.calls:
        return None
    return ctx.trace.range_s("stage:hough_hypotheses") * 1e3 / ctx.calls
