"""The isotropic resample's least time (``roofline_isotropic.resample_bytes``:
each input voxel read once and each output voxel written once, 4 bytes
each, at 3.35 TB/s) over the device time inside the program's
"stage:resample" spans, in percent."""

import roofline_isotropic


def read(ctx):
    if ctx.trace is None or "stage:resample" not in ctx.trace.ranges:
        return None
    device_s = ctx.trace.device_s_in("stage:resample", device=(ctx.devices or [0])[0])
    if device_s <= 0:
        return None
    n_bytes = roofline_isotropic.resample_bytes(ctx.config["grid_zyx"], ctx.config["extraction_grid_zyx"], ctx.units)
    least_ms, _ = ctx.roofline.bound(n_bytes, 0.0)
    return 100.0 * least_ms / 1e3 / device_s
