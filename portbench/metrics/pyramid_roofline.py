"""The pyramid's least time (``roofline.pyramid_bytes``: every blur, the
DoG and extrema pass and the subsample, each input byte read once and each
output byte written once, at 3.35 TB/s) over the device time inside the
"stage:initial_blur" and "stage:pyramid" ranges, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_s_in("stage:initial_blur", "stage:pyramid", device=(ctx.devices or [0])[0])
    if device_s <= 0:
        return None
    least_ms, _ = ctx.roofline.bound(ctx.roofline.pyramid_bytes(ctx.config["grid_zyx"], ctx.units), 0.0)
    least_s = least_ms / 1e3
    return 100.0 * least_s / device_s
