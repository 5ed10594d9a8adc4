"""Host milliseconds inside the program's "stage:resample" spans (each
sub-batch's isotropic resample on the card, featExtract's -w,
``pipeline/extract.py``), per volume."""


def read(ctx):
    if ctx.trace is None or "stage:resample" not in ctx.trace.ranges or not ctx.units:
        return None
    return ctx.trace.range_s("stage:resample") * 1e3 / ctx.units
