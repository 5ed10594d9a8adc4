"""The doubling's least time (``roofline_prescale.upsample_bytes``: each
input voxel read once, its 8 outputs written once, at 3.35 TB/s) over the
device time inside the program's "stage:upsample" spans, in percent."""

import roofline_prescale


def read(ctx):
    if ctx.trace is None or "stage:upsample" not in ctx.trace.ranges:
        return None
    device_s = ctx.trace.device_s_in("stage:upsample", device=(ctx.devices or [0])[0])
    if device_s <= 0:
        return None
    least_ms, _ = ctx.roofline.bound(roofline_prescale.upsample_bytes(ctx.config["grid_zyx"], ctx.units), 0.0)
    return 100.0 * least_ms / 1e3 / device_s
