"""The traced window: a ``torch.profiler`` trace of the card, reduced to
intervals.

Device busy time is the union of the device's kernel, copy and set
intervals (events that overlap count once), per device; the idle share is
1 - busy / window. Launch calls are the CUDA runtime's kernel launch
calls. Ranges are the harness's "span:" and "stage:" ranges on the host
(``spans``), and "window" the traced window itself; the profiler also
mirrors a range on the device as an annotation, which is not device work
and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
RANGE_PREFIXES = ("span:", "stage:")
WINDOW = "window"

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def overlap(merged: List[Interval], ranges: List[Interval]) -> float:
    """Length of merged intervals (disjoint) inside the union of ranges."""
    return sum(length(clip(merged, s, e)) for s, e in union(ranges))


@dataclasses.dataclass
class Trace:
    """A traced window, times in microseconds on the profiler's clock."""

    window: Interval
    busy: Dict[int, List[Interval]]  # device index -> merged device intervals in the window
    kernels: List[Tuple[str, int, float]]  # (name, device index, duration)
    launches: int
    ranges: Dict[str, List[Interval]]  # "span:x" / "stage:x" -> host intervals

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, devices) -> float:
        """Busy seconds averaged over the given device indices."""
        return sum(length(self.busy.get(d, [])) for d in devices) / len(devices) / 1e6

    def range_s(self, *names: str) -> float:
        """Host seconds inside the named ranges (their union)."""
        return length(union([iv for n in names for iv in self.ranges.get(n, [])])) / 1e6

    def device_s_in(self, *names: str, device: int = 0) -> float:
        """Device busy seconds that fall inside the named ranges."""
        return overlap(self.busy.get(device, []), [iv for n in names for iv in self.ranges.get(n, [])]) / 1e6

    def breakdown(self, devices, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the devices grouped by the innermost range the host was in (the
        seconds summed over the devices)."""
        ops: Dict[str, float] = {}
        for name, _, dur in self.kernels:
            ops[name] = ops.get(name, 0.0) + dur / 1e6
        gaps: Dict[str, float] = {}
        ranges = [(s, e, n) for n, ivs in self.ranges.items() for s, e in ivs]
        for d in devices:
            edges = [self.window[0]] + [t for iv in self.busy.get(d, []) for t in iv] + [self.window[1]]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e <= s:
                    continue
                mid = 0.5 * (s + e)
                inside = [(re - rs, n) for rs, re, n in ranges if rs <= mid <= re]
                name = min(inside)[1] if inside else "host outside the harness's ranges"
                gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(ops), "idle_gaps": first(gaps)}


def reduce(events) -> Optional[Trace]:
    """A Trace from a profiler's events; None without a "window" range."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    window = None
    ranges: Dict[str, List[Interval]] = {}
    launch_at: List[float] = []
    raw: Dict[int, List[Interval]] = {}
    kernels = []
    for e in events:
        name = e.name
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if name == WINDOW or name.startswith(RANGE_PREFIXES):
                continue  # the device's mirror of a host range
            raw.setdefault(int(e.device_index), []).append((start, end))
            kernels.append((name[:120], int(e.device_index), end - start))
        elif e.device_type == cpu:
            if name == WINDOW:
                window = (start, end)
            elif name.startswith(RANGE_PREFIXES):
                ranges.setdefault(name, []).append((start, end))
            elif name in LAUNCH_CALLS:
                launch_at.append(start)
    if window is None:
        return None
    busy = {d: union(clip(ivs, *window)) for d, ivs in raw.items()}
    launches = sum(1 for t in launch_at if window[0] <= t <= window[1])
    return Trace(window, busy, kernels, launches, ranges)
