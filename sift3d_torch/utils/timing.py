"""The port's span tracer: named steps of the host that never wait for the device.

Every step of the program that a trace should name opens
``tracer.stage(name)``. :data:`TRACER` is the process's tracer, the one an
entry point uses when its caller passes no ``timer=``; a caller may pass
any object with the same ``stage(name)`` context manager (another
:class:`Tracer`, a benchmark's own spans).

A span costs a flag check unless something watches it:

- under an active ``torch.profiler`` it opens the range ``stage:<name>``
  (``record_function``), on the profiler's clock beside the device's
  events, so a trace can put each idle gap of the device down to the
  innermost step the host was in;
- while recording (:meth:`Tracer.record`, the CLI's ``--time``) it keeps a
  :class:`Span` in memory: name, start and end (``time.monotonic_ns``),
  parent, the top-level span it belongs to, thread and, on a CUDA device,
  a pair of CUDA events on the device's current stream.
  :meth:`Tracer.totals`, after the run, waits for those events and sums
  per name the calls, host ms, self ms (less the spans inside it) and
  stream ms (between the events);
- otherwise ``stage`` returns one shared ``nullcontext``.

``tracer.count(name, n)`` adds n to a counter while recording and is a
flag check otherwise; :meth:`Tracer.summary` prints the counters below the
spans.

No path calls ``torch.cuda.synchronize``. Each thread nests its spans on
its own stack and appends to the record under a lock, so host threads
that each extract (``dist/batch.py``) record side by side. A generator
closes its spans before it yields, so a caller that abandons it leaves
none open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "stage:"  # a span's range name under the profiler is PREFIX + name
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span; ids are unique within a tracer."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span it ran inside, in the same thread
    call: int  # the id of its top-level span
    thread: int
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]


@dataclasses.dataclass
class Totals:
    """The spans of one name: calls, host ms, self ms (host ms less the
    host ms of the spans directly inside them), stream ms (None without
    CUDA events)."""

    calls: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    stream_ms: Optional[float] = None


class Tracer:
    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._recording = False
        self._device: Optional[torch.device] = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def stage(self, name: str):
        """A context manager around one step named `name`."""
        if not (self._recording or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return self._span(name)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name` while recording; nothing otherwise."""
        if not self._recording:
            return
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def _span(self, name: str):
        profiled = _autograd_profiler._is_profiler_enabled
        with torch.profiler.record_function(PREFIX + name) if profiled else _OFF:
            if not self._recording:
                yield
                return
            stack = self._local.__dict__.setdefault("stack", [])
            sid = next(self._ids)
            parent, call = stack[-1] if stack else (None, sid)
            events = None
            if self._device is not None:
                stream = torch.cuda.current_stream(self._device)
                events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            stack.append((sid, call))
            start = time.monotonic_ns()
            try:
                yield
            finally:
                end = time.monotonic_ns()
                if events is not None:
                    events[1].record(stream)
                stack.pop()
                span = Span(name, start, end, sid, parent, call, threading.get_ident(), events)
                with self._lock:
                    self.spans.append(span)

    @contextlib.contextmanager
    def record(self, device=None):
        """Keep every span opened and every count made inside the block
        (those of an earlier record are dropped when it starts). device: a
        CUDA device, whose current stream gets each span's pair of events;
        None or another device records host times only."""
        device = None if device is None else torch.device(device)
        with self._lock:
            self.spans = []
            self.counts = {}
        self._device = device if device is not None and device.type == "cuda" else None
        self._recording = True
        try:
            yield self
        finally:
            self._recording = False

    def totals(self) -> Dict[str, Totals]:
        """Per span name, in the order of first start, the recorded spans'
        :class:`Totals`. The only wait of the tracer: for the recorded
        events to complete, before it reads them."""
        spans = sorted(self.spans, key=lambda s: s.start_ns)
        inner: Dict[int, int] = {}
        for s in spans:
            if s.parent is not None:
                inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
        out: Dict[str, Totals] = {}
        for s in spans:
            t = out.setdefault(s.name, Totals())
            t.calls += 1
            t.host_ms += (s.end_ns - s.start_ns) / 1e6
            t.self_ms += (s.end_ns - s.start_ns - inner.get(s.id, 0)) / 1e6
            if s.events is not None:
                s.events[1].synchronize()  # until this span's end event has run
                t.stream_ms = (t.stream_ms or 0.0) + s.events[0].elapsed_time(s.events[1])
        return out

    def summary(self) -> str:
        """:meth:`totals` as a table, then the counters."""
        lines = [f"{'span':24s} {'calls':>6s} {'host ms':>10s} {'self ms':>10s} {'stream ms':>10s}"]
        for name, t in self.totals().items():
            stream = "-" if t.stream_ms is None else f"{t.stream_ms:10.2f}"
            lines.append(f"{name:24s} {t.calls:6d} {t.host_ms:10.2f} {t.self_ms:10.2f} {stream:>10s}")
        if self.counts:
            lines.append(f"{'counter':24s} {'count':>17s}")
            lines += [f"{name:24s} {n:17d}" for name, n in self.counts.items()]
        return "\n".join(lines)


TRACER = Tracer()
