"""The group vote's kNN least time, 2 * N * N * 64 int8 operations over
1,979 TOP/s for the N stacked rows, over the device time inside the
harness's "span:group_vote" ranges, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_s_in("span:group_vote", device=(ctx.devices or [0])[0])
    if device_s <= 0:
        return None
    least_ms, _ = ctx.roofline.bound(0.0, 0.0, ctx.roofline.knn_int8_ops(ctx.state["vote_rows"]) * ctx.calls)
    least_s = least_ms / 1e3
    return 100.0 * least_s / device_s
