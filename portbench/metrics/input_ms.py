"""Host milliseconds inside the program's "stage:input" spans (the volumes'
host copy, upload and stack in ``pipeline/extract.py``), per volume."""


def read(ctx):
    if ctx.trace is None or "stage:input" not in ctx.trace.ranges or not ctx.units:
        return None
    return ctx.trace.range_s("stage:input") * 1e3 / ctx.units
