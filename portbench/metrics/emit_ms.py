"""Host milliseconds inside the program's "stage:emit" spans (each octave's
row sort, the rows' copy to the host, their split into FeatureSets and the
final concatenation, in ``pipeline/extract.py``), per volume."""


def read(ctx):
    if ctx.trace is None or "stage:emit" not in ctx.trace.ranges or not ctx.units:
        return None
    return ctx.trace.range_s("stage:emit") * 1e3 / ctx.units
