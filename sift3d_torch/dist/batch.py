"""Extraction over many volumes by placement: each mesh entry extracts a
round-robin group of the volumes, whole, on its own device.

The port's counterpart of ``sift3d.dist.batch``. A volume's pipeline
(dense pyramid, candidates, the ragged feature stage, descriptors) never
leaves the device that holds it, so no byte moves between devices: volumes
are independent, as in the reference, which runs one volume per GPU
(featExtract.cpp:315-328). One host thread per entry keeps each entry's
queue full and overlaps the groups' host work (the candidate counts, the
row split, the FeatureSets); inside an entry, same-shape volumes run as one
batch (``extract_features_many``). The JAX package's ``streams`` and
``reoriented`` options are not ported (``extract_features_many`` has
neither).

Entries that run at once share the host's cores. Each one's host volumes
stage through its device's ring on its own share of them
(``pipeline.staging.shared_copy`` with :func:`copy_threads`' k), not on
torch's OpenMP team of one thread a core: four such teams on a node's 32
cores, one an entry, held every entry's copies back. One entry keeps the
ring's usual routes.

Spans and counters (``utils.timing.TRACER``, on the calling thread, never
synchronizing): ``place`` holds one call, from dealing the volumes to the
last entry's result; ``place_tail``, inside it, runs from the first
entry's result to the last, the time the node works on fewer than all its
entries (not opened for one entry). While recording, ``placed_volumes``
and ``placed_entries`` count each call's volumes and entries, and the
ring's ``shared_copy_volumes`` the volumes staged on the entries' shares.
The entries' own spans (``input``, ``pyramid``, ``emit``, ...) open in
their host threads: a profiler sees them only when it records every
thread, not just the one that started it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import os
from typing import List, Optional, Sequence

import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.pipeline import pyramid, staging
from sift3d_torch.pipeline.extract import extract_features_many
from sift3d_torch.utils.timing import TRACER


def initial_blur_batch(vols: torch.Tensor, cfg: SiftConfig = DEFAULT_CONFIG):
    """The initial blur of a [B, Z, Y, X] batch (one K7 launch on the card)."""
    return pyramid.initial_blur_core(vols, cfg)


def octave_step_batch(bases: torch.Tensor, cfg: SiftConfig = DEFAULT_CONFIG):
    """One octave of a [B, Z, Y, X] batch of bases: (gstack [B, 6, Z, Y, X],
    dogs [B, 5, ...], mask [B, 3, ...] int8, next_base [B, Z/2, Y/2, X/2]),
    the program ``extract_features_many`` runs per shape group."""
    return pyramid.octave_core(bases, cfg)


def on_device(dev: torch.device):
    """A context that makes dev the calling thread's current CUDA device (the
    kernels' C entries select it too); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# cores of an entry's share a copy thread: on a node of four H100s and 32
# cores, of k = 1, 2, 4 and the whole share, k = 1 staged fastest at four
# entries (8 cores each) and k = 2 at two (16 each); a thread more a piece
# only adds waits for the interpreter lock (PERF.md §6)
CORES_PER_COPY_THREAD = 8


def copy_threads(entries: int) -> int:
    """The threads each of `entries` entries that run at once copies its
    host volumes on (``staging.shared_copy``): one for every
    CORES_PER_COPY_THREAD cores of its even share of the cores this process
    may use, at least one."""
    return max(1, len(os.sched_getaffinity(0)) // (CORES_PER_COPY_THREAD * entries))


def extract_features_batch(
    vols: Sequence, mesh: Optional[Sequence] = None, cfg: SiftConfig = DEFAULT_CONFIG, *,
    descriptor: str = "goh", prescale: Optional[str] = None,
) -> List[FeatureSet]:
    """Extract features from [Z, Y, X] volumes (numpy arrays or tensors)
    over a mesh; returns one FeatureSet per volume, in input order, each
    equal bit for bit to ``extract_features`` on that volume alone.

    mesh: an ordered list of devices (``dist.mesh.make_mesh``), which may
    repeat one; None means every CUDA device, and raises without one. The
    volumes are dealt round-robin over the first min(len(mesh), len(vols))
    entries; each entry runs ``extract_features_many`` on its group in a
    host thread of its own. An entry's error is raised here. descriptor
    and prescale as in ``extract_features`` (under "isotropic" the volumes
    are Scans and the features come back in world millimetres)."""
    mesh = make_mesh(devices=mesh)
    if not len(vols):
        return []
    n = min(len(mesh), len(vols))
    threads = copy_threads(n) if n > 1 else None

    def run(dev: torch.device, ids: List[int]) -> List[FeatureSet]:
        share = staging.shared_copy(threads) if threads else contextlib.nullcontext()
        with on_device(dev), share:
            return extract_features_many(
                [vols[i] for i in ids], cfg, device=dev, descriptor=descriptor, prescale=prescale,
            )

    out: List[Optional[FeatureSet]] = [None] * len(vols)
    TRACER.count("placed_volumes", len(vols))
    TRACER.count("placed_entries", n)
    with TRACER.stage("place"), concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
        groups = [list(range(e, len(vols), n)) for e in range(n)]
        jobs = {ex.submit(run, mesh[e], ids): ids for e, ids in enumerate(groups)}
        done = concurrent.futures.as_completed(jobs)
        first = next(done)
        with TRACER.stage("place_tail") if n > 1 else contextlib.nullcontext():
            for job in itertools.chain([first], done):
                for i, f in zip(jobs[job], job.result()):
                    out[i] = f
    return out
