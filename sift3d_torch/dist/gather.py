"""Exact kNN with the queries sharded over a mesh, and the gathering of
per-device keypoint blocks.

The port's counterpart of ``sift3d.dist.gather``, the matcher's OpenMP
image-chunk loop spread over devices (featMatchMultiple.cpp:108-117): the
database is copied to every mesh entry, each entry runs M1
(``kernels.knn_cuda.knn_topk``) once on a contiguous chunk of the queries,
on its own device and current stream, and the [Q_e, k] results come back
to ``mesh[0]`` in query order. M1 treats each query row on its own, so the
result equals ``match.knn.knn_search`` on the whole query set bit for bit,
the (distance, index) tie order included. Under a process group of more
than one process (``dist.multihost``) the queries are first split over the
ranks, rank r taking the r-th contiguous share over its local mesh, and the
rows are all-gathered in rank order. Copies between two cards go through
``Tensor.to``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from sift3d_torch.core.device import resolve_device
from sift3d_torch.dist import multihost
from sift3d_torch.dist.batch import on_device
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.match.knn import knn_search


def split_bounds(n: int, parts: int) -> List[int]:
    """parts + 1 ascending bounds cutting range(n) into contiguous chunks
    whose sizes differ by at most one, the larger first."""
    base, extra = divmod(n, parts)
    return [i * base + min(i, extra) for i in range(parts + 1)]


def sharded_knn(queries, db, k: int, mesh: Optional[Sequence] = None):
    """Exact kNN of queries [Q, C] against db [N, C] (numpy arrays or
    tensors), the queries split over the mesh's entries and the database
    copied to each: (dist [Q, k] f32, idx [Q, k] int64) on ``mesh[0]``,
    sorted ascending by (distance, index), equal to ``knn_search``.

    mesh: an ordered list of devices (may repeat one); None means every
    CUDA device, and raises without one. An empty query set or database,
    or k = 0, gives zeros, and k > N raises, as in ``knn_search``."""
    mesh = [resolve_device(d) for d in make_mesh(devices=mesh)]
    home = mesh[0]
    q = torch.as_tensor(queries, dtype=torch.float32)
    d = torch.as_tensor(db, dtype=torch.float32)
    nq, n = q.shape[0], d.shape[0]
    if nq == 0 or n == 0 or k == 0:
        return knn_search(q, d, k, device=home)
    if k > n:
        raise ValueError(f"k exceeds database size: k={k}, N={n}")
    rank, size = multihost.world()
    ranks = split_bounds(nq, size)
    lo = ranks[rank]
    bounds = [lo + b for b in split_bounds(ranks[rank + 1] - lo, len(mesh))]
    # every input copy first, then every launch, then every result copy: a
    # copy between two cards runs on the source card's stream, behind what is
    # queued there, so an interleaved order would run the cards' M1 in turn
    replicas = {dev: d.to(dev) for dev in dict.fromkeys(mesh)}  # one copy per distinct device
    work = [(dev, q[a:b].to(dev)) for dev, a, b in zip(mesh, bounds[:-1], bounds[1:]) if b > a]
    results = []
    for dev, chunk in work:
        with on_device(dev):
            results.append(knn_search(chunk, replicas[dev], k, device=dev))
    # the empty pair keeps the shapes when this rank's share has no rows
    empty = (torch.zeros((0, k), device=home), torch.zeros((0, k), dtype=torch.int64, device=home))
    return tuple(multihost.all_gather_rows(torch.cat([r[i].to(home) for r in results] + [empty[i]]))
                 for i in (0, 1))


def gather_keypoint_sets(blocks: Sequence[torch.Tensor], mesh: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Per-entry descriptor blocks [b_i, N, D] (block i on mesh entry i)
    gathered into the full database [sum b_i * N, D], one copy on every
    entry, in entry order. mesh None: every CUDA device."""
    mesh = [resolve_device(d) for d in make_mesh(devices=mesh)]
    if len(blocks) != len(mesh):
        raise ValueError(f"one block per mesh entry: {len(blocks)} blocks, {len(mesh)} entries")
    full = torch.cat([b.to(mesh[0]) for b in blocks])
    full = full.reshape(-1, full.shape[-1])
    return [full.to(dev) for dev in mesh]
