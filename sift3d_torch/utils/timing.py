"""Per-stage wall-clock timing that waits for the device.

Each stage synchronizes CUDA (once it is initialized) on entry and exit,
so a stage's time is the device work it launched, not the enqueue. A
disabled timer adds nothing (and no synchronization) to the run.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def milliseconds(self) -> Dict[str, float]:
        return {name: self.totals[name] * 1e3 for name in self.totals}

    def summary(self) -> str:
        return "\n".join(
            f"{name:36s} {self.totals[name] * 1e3:10.2f} ms  x{self.counts[name]}"
            for name in sorted(self.totals)
        )
