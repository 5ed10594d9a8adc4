"""The harness's spans, opened from the benchmark's own files.

``span(name)`` wraps a call into one layer of the program in a
``torch.profiler.record_function`` range "span:<name>"; ``stage(name)`` is
the stage timer the extraction entry points take as ``timer=`` (the
pattern of ``chip_smoke.py``'s StageMarks): it opens "stage:<name>" around
initial_blur, pyramid, candidates, gather_eig, canonical and descriptors.
Both synchronize every device on entry and exit, so a range holds the
device work that it launched, and both exist only in a traced run: an
untraced run gets :data:`OFF`, which adds nothing.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


class Spans:
    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]

    def _sync(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def _range(self, label: str):
        self._sync()
        with torch.profiler.record_function(label):
            yield
            self._sync()

    def span(self, name: str):
        return self._range(f"span:{name}")

    def stage(self, name: str):
        return self._range(f"stage:{name}")

    @property
    def timer(self):
        """The object to pass as ``timer=``."""
        return self


class _Off:
    timer = None

    @staticmethod
    def span(name: str):
        return contextlib.nullcontext()


OFF = _Off()
