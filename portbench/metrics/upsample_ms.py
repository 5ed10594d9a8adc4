"""Host milliseconds inside the program's "stage:upsample" spans (each
sub-batch's doubling on the card, ``pipeline/extract.py``), per volume."""


def read(ctx):
    if ctx.trace is None or "stage:upsample" not in ctx.trace.ranges or not ctx.units:
        return None
    return ctx.trace.range_s("stage:upsample") * 1e3 / ctx.units
