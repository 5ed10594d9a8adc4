"""The pyramid's least time on the grid it runs at, the doubled one
(``roofline_prescale.prescaled_pyramid_bytes``: every blur, the DoG and
extrema pass and the subsample, each input byte read once and each output
byte written once, at 3.35 TB/s), over the device time inside the
"stage:initial_blur" and "stage:pyramid" ranges, in percent."""

import roofline_prescale


def read(ctx):
    if ctx.trace is None or "extraction_grid_zyx" not in ctx.config:
        return None
    device_s = ctx.trace.device_s_in("stage:initial_blur", "stage:pyramid", device=(ctx.devices or [0])[0])
    if device_s <= 0:
        return None
    least_ms, _ = ctx.roofline.bound(roofline_prescale.prescaled_pyramid_bytes(ctx.config, ctx.units), 0.0)
    return 100.0 * least_ms / 1e3 / device_s
