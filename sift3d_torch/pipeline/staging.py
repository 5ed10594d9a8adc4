"""Host volumes into device memory through a ring of pinned staging slots.

A host volume (a numpy array of any real dtype, order and strides, or a
CPU tensor) bound for a card travels in chunks of its flat f32 extent
(C order). For each chunk the ring takes its next slot, a fixed buffer of
page-locked host memory, and

  waits on the slot's CUDA event (a host wait on the slot's last copy,
  never a device or stream synchronize),
  copies and casts the chunk from the caller's array into the slot (the one
  host pass over the volume; the cast of ``np.array(img, np.float32)``),
  issues an asynchronous copy from the slot into the chunk's place in the
  destination on the device's current stream, and records the slot's
  event there.

So the host copy of one chunk overlaps the transfer of the chunks before
it, within a volume and across the volumes of a batch, and the kernels
that read the destination are ordered after the copies by the stream
alone. The caller's array is never pinned, registered or kept.

The host copy sets the pace (an H100's 8-core host: numpy's copy 4.6–5.5
GB/s, torch's intra-op copy 13–17, the pinned transfer 39–44), and it has
three routes:

- the volumes of a batch copy on torch's intra-op threads (an OpenMP team
  of one thread a core) wherever torch can view the array: a batch's rate
  is what its caller waits for;
- a single volume copies on the calling thread alone (numpy's copy): on
  the 8-core host, in a closed loop over T1 volumes, the copy spread over
  every core shortened the median latency by ~2 ms but lengthened the
  95th percentile by ~8 ms against the one-thread copy;
- inside :func:`shared_copy`, an array copies on k threads of numpy's
  copy and no OpenMP team: each chunk splits into up to k contiguous
  pieces, the calling thread copies the first and k - 1 workers of the
  ring the rest. The placement (``dist/batch.py``) stages its entries'
  volumes so when it runs several at once: k is one thread for every 8
  cores of an entry's share of the host's (``copy_threads``). On a node
  of four H100s and 32 cores, four entries ran the node at 129.4
  volumes/s on four OpenMP teams of 32 threads and at 233.9, 220.5,
  171.5 and 140.2 on k = 1, 2, 4 and 8; two entries at 306.2 on k = 2,
  against 245.3, 254.6 and 121.7 on k = 1, 4 and 16.

A ring belongs to one device (:func:`ring`: made on first use, kept for
the process) and a lock serializes the volumes staged through it, so host
threads that each extract on their own card (``dist/batch.py``) never share
a slot. A ring on the CPU (unpinned slots, plain copies, no events) runs
the same chunk walk; the tests hold it against ``np.array``.

While ``TRACER`` records, the ring counts ``staged_volumes``,
``staged_bytes`` (f32 bytes written to the destination),
``shared_copy_volumes`` (volumes copied on :func:`shared_copy`'s route)
and ``slot_waits`` (chunks whose slot was still in flight when the host
reached it: beside the chunk count, which of the host copy and the
transfer sets the pace). It opens no span: the caller's ``input`` span
holds the staging.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import math
import threading
from typing import Dict, Optional

import numpy as np
import torch

from sift3d_torch.utils.timing import TRACER

# measured on an H100's host (8 cores): 16 MiB chunks staged a T1 volume
# fastest; no slot was ever still in flight at depth 2, so more slots buy
# nothing
CHUNK_BYTES = 16 << 20  # one slot
DEPTH = 2  # slots a ring

_SHARE = threading.local()  # .threads: the calling thread's shared_copy k


@contextlib.contextmanager
def shared_copy(k: int):
    """Within the block, the arrays this thread stages copy on k threads of
    numpy's copy (this one and k - 1 workers of the ring) and on no OpenMP
    team, whatever ``stage``'s parallel says; CPU tensors copy as before.
    The bits are the same on every route."""
    if k < 1:
        raise ValueError(f"shared_copy needs k >= 1 threads, got {k}")
    outer = getattr(_SHARE, "threads", None)
    _SHARE.threads = int(k)
    try:
        yield
    finally:
        _SHARE.threads = outer


def _copy_range(src, dst, lo: int, hi: int, copy) -> None:
    """copy(view of dst, view of src) over elements lo..hi of src's C-order
    flattening, dst flat and hi - lo long: src's rows split at the range's
    ends and whole blocks between, so no piece is flattened (a copy of an
    F-ordered or strided array) and every piece is a view."""
    if src.ndim <= 1:
        copy(dst, src[lo:hi])
        return
    inner = math.prod(src.shape[1:])
    i0, r0 = divmod(lo, inner)
    i1, r1 = divmod(hi, inner)
    if i0 == i1:
        _copy_range(src[i0], dst, r0, r1, copy)
        return
    at = 0
    if r0:
        at = inner - r0
        _copy_range(src[i0], dst[:at], r0, inner, copy)
        i0 += 1
    if i1 > i0:
        n = (i1 - i0) * inner
        copy(dst[at : at + n].reshape((i1 - i0,) + tuple(src.shape[1:])), src[i0:i1])
        at += n
    if r1:
        _copy_range(src[i1], dst[at:], 0, r1, copy)


def _numpy_copy(dst: np.ndarray, src: np.ndarray) -> None:
    np.copyto(dst, src, casting="unsafe")


def _tensor_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src)


class _Readable:
    """A read-only array's interface flagged writable, so that
    ``torch.from_numpy`` views it without its warning; the ring only reads
    through the view."""

    def __init__(self, arr: np.ndarray):
        self.arr = arr  # keeps the memory alive as long as the view
        self.__array_interface__ = dict(arr.__array_interface__, data=(arr.ctypes.data, False))


def _source(img, parallel: bool):
    """What the ring copies from: a CPU tensor itself (torch's copy); an
    array, with parallel, as a tensor over its memory wherever torch takes
    one (torch's intra-op copy), else as a numpy array (numpy's copy on the
    calling thread; also for another byte order, a negative stride or a
    dtype torch lacks)."""
    if isinstance(img, torch.Tensor):
        return img.detach()
    arr = np.asarray(img)
    if not parallel or not arr.dtype.isnative or min(arr.strides, default=0) < 0:
        return arr
    try:
        return torch.from_numpy(arr if arr.flags.writeable else np.asarray(_Readable(arr)))
    except TypeError:  # no tensor of this dtype
        return arr


def _fill(src, slot: torch.Tensor, lo: int, hi: int) -> None:
    """Elements lo..hi of src (``_source``'s) into slot."""
    if isinstance(src, torch.Tensor):
        _copy_range(src, slot, lo, hi, _tensor_copy)
    else:
        _copy_range(src, slot.numpy(), lo, hi, _numpy_copy)


class StagingRing:
    """DEPTH host slots of CHUNK_BYTES for one device: pinned, each with a
    CUDA event, for a card; plain, without events, for the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.chunk = CHUNK_BYTES // 4  # f32 elements a slot
        self.slots = [torch.empty(self.chunk, dtype=torch.float32, pin_memory=cuda) for _ in range(DEPTH)]
        self.events = [torch.cuda.Event() for _ in range(DEPTH)] if cuda else None
        self._next = 0
        self._lock = threading.Lock()
        self._copiers: Optional[concurrent.futures.ThreadPoolExecutor] = None  # shared_copy's workers
        self._copier_count = 0

    def _workers(self, count: int) -> concurrent.futures.ThreadPoolExecutor:
        """A pool of at least count persistent copy workers (under the
        ring's lock: no copy of the previous pool is in flight)."""
        if self._copier_count < count:
            if self._copiers is not None:
                self._copiers.shutdown()
            self._copiers = concurrent.futures.ThreadPoolExecutor(count, thread_name_prefix=f"staging-{self.device}")
            self._copier_count = count
        return self._copiers

    def _fill_shared(self, src: np.ndarray, slot: torch.Tensor, lo: int, hi: int, k: int) -> None:
        """``_fill``'s numpy copy of elements lo..hi of src into slot, split
        into up to k contiguous pieces: the first on this thread, the others
        on the ring's workers; returns when every piece is written."""
        out = slot.numpy()
        parts = min(k, hi - lo)
        cuts = [lo + (hi - lo) * i // parts for i in range(parts + 1)]
        pool = self._workers(parts - 1) if parts > 1 else None
        jobs = [pool.submit(_copy_range, src, out[a - lo : b - lo], a, b, _numpy_copy)
                for a, b in zip(cuts[1:-1], cuts[2:])]
        try:
            _copy_range(src, out[: cuts[1] - lo], lo, cuts[1], _numpy_copy)
        finally:
            concurrent.futures.wait(jobs)  # no worker writes the slot past this point
        for job in jobs:
            job.result()

    def stage(self, img, dst: torch.Tensor, parallel: bool = True) -> None:
        """Write img, cast to f32, into dst (a contiguous f32 tensor of
        img's shape on the ring's device): the bits of
        ``np.array(img, np.float32)`` for an array, of ``img.float()`` for a
        CPU tensor. parallel: an array's host copy may run on torch's
        intra-op threads (``_source``); inside :func:`shared_copy` an array
        copies on its k threads instead. On a card the copies are
        asynchronous: dst is complete for work ordered after them on the
        device's current stream."""
        threads = getattr(_SHARE, "threads", None)
        src = _source(img, parallel and threads is None)
        shared = threads is not None and isinstance(src, np.ndarray)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"a volume of shape {tuple(src.shape)} staged into {tuple(dst.shape)}")
        flat = dst.view(-1)
        total = flat.numel()
        waits = 0
        with self._lock:
            for lo in range(0, total, self.chunk):
                hi = min(lo + self.chunk, total)
                k = self._next
                self._next = (k + 1) % len(self.slots)
                slot = self.slots[k][: hi - lo]
                if self.events is not None and not self.events[k].query():
                    waits += 1
                    self.events[k].synchronize()
                if shared:
                    self._fill_shared(src, slot, lo, hi, threads)
                else:
                    _fill(src, slot, lo, hi)
                flat[lo:hi].copy_(slot, non_blocking=self.events is not None)
                if self.events is not None:
                    self.events[k].record(torch.cuda.current_stream(self.device))
        TRACER.count("staged_volumes")
        TRACER.count("staged_bytes", 4 * total)
        TRACER.count("shared_copy_volumes", int(shared))
        TRACER.count("slot_waits", waits)


_RINGS: Dict[torch.device, StagingRing] = {}
_RINGS_LOCK = threading.Lock()


def ring(device) -> StagingRing:
    """The staging ring of `device` (an indexed CUDA device), made on first
    use and kept for the process."""
    dev = torch.device(device)
    with _RINGS_LOCK:
        if dev not in _RINGS:
            _RINGS[dev] = StagingRing(dev)
        return _RINGS[dev]
