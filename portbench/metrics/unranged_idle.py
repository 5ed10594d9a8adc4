"""The device's idle time that no range names, over the traced window: the
idle gaps whose midpoint lies in no "span:" or "stage:" range (the
breakdown's "host outside the harness's ranges"), summed and averaged
over the cell's cards, as a share of the window."""

import bisect


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.window_s <= 0:
        return None
    merged = []  # the union of every range, as the breakdown's closed intervals
    for s, e in sorted(iv for ivs in trace.ranges.values() for iv in ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    devices = ctx.devices or [0]
    unranged = 0.0
    for d in devices:
        edges = [trace.window[0]] + [t for iv in trace.busy.get(d, []) for t in iv] + [trace.window[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            k = bisect.bisect_right(starts, mid) - 1
            if k < 0 or mid > merged[k][1]:
                unranged += e - s
    return unranged / 1e6 / len(devices) / trace.window_s
