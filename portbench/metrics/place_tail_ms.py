"""Host milliseconds inside the program's "stage:place_tail" spans (a
placement call's time from its first entry's result to its last, in
``dist/batch.py``: the node works on fewer than all its cards), per call."""


def read(ctx):
    if ctx.trace is None or "stage:place_tail" not in ctx.trace.ranges or not ctx.calls:
        return None
    return ctx.trace.range_s("stage:place_tail") * 1e3 / ctx.calls
