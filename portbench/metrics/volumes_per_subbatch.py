"""Volumes over the program's "stage:input" spans in the traced window:
``extract_features_many`` opens one for each sub-batch it splits a shape
group into, so this is the volumes a sub-batch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ranges.get("stage:input"):
        return None
    return ctx.units / len(ctx.trace.ranges["stage:input"])
