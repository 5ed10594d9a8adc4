"""The weighted similarity fit with its correspondences sharded over a mesh.

The port's counterpart of ``sift3d.dist.solve.solve_similarity_sharded``:
each mesh entry reduces its share of the correspondences to f64 moments,
the partials are combined on ``mesh[0]``, and the 3 x 3 solve runs once in
f64 on the host (``match.solve.solve_from_moments``). The result equals
``match.solve.solve_similarity(p, q, w)`` bit for bit at every mesh size,
because the shares follow ``numerics.tree_sum``'s pairing: the single
device pads the N rows to a power of two W and adds row i + W/2 to row i
until one is left, so after log2(W / S) halvings element j holds the
tree sum of rows j, j + S, j + 2S, ... in that tree's own order. With S
logical shards (a power of two, at least the number of mesh entries and at
most W), shard j takes exactly those rows, each shard sums them with
tree_sum, and tree_sum over the S partials in shard order finishes the
single device's tree. A contiguous split would not give that order.
Under a process group of more than one process (``dist.multihost``) the
mesh entries of all ranks share the shards (ranks the outer axis), and the
partials are all-gathered and summed in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.numerics import tree_sum
from sift3d_torch.dist import multihost
from sift3d_torch.dist.batch import on_device
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.match.solve import as_points, moments, solve_from_moments

MOMENT_COLUMNS = 17  # sw 1, sp 3, sq 3, spp 1, spq 9


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def shard_rows(x: torch.Tensor, n_shards: int, shards: Sequence[int]) -> torch.Tensor:
    """The rows of the logical shards `shards` of x [N, ...]: [len(shards),
    W / n_shards, ...], shard j holding rows j, j + n_shards, ... of x
    zero-padded to tree_sum's width W."""
    width = pow2_at_least(x.shape[0])
    x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, width - x.shape[0]))
    take = torch.as_tensor(list(shards), dtype=torch.int64, device=x.device)
    return x.reshape(width // n_shards, n_shards, *x.shape[1:])[:, take].movedim(1, 0)


def solve_similarity_sharded(p, q, w, mesh: Optional[Sequence] = None):
    """Weighted similarity fit p -> q of [N, 3] points with [N] weights
    (numpy arrays or tensors), the correspondences
    sharded over the mesh: (scale, rot [3, 3], trans [3]) in f64, equal to
    ``solve_similarity(p, q, w)``. mesh: an ordered list of devices (may
    repeat one); None means every CUDA device, and raises without one."""
    mesh = [resolve_device(d) for d in make_mesh(devices=mesh)]
    rank, size = multihost.world()
    src = p.device if isinstance(p, torch.Tensor) else torch.device("cpu")
    p, q, w = as_points(p, q, w, src)
    n_entries = size * len(mesh)
    n_shards = min(pow2_at_least(n_entries), pow2_at_least(p.shape[0]))
    # shard j goes to global entry j % n_entries: rank g // len(mesh)'s entry g % len(mesh)
    entry_of = [j % n_entries for j in range(n_shards)]
    parts = []
    for e, dev in enumerate(mesh):
        shards = [j for j in range(n_shards) if entry_of[j] == rank * len(mesh) + e]
        if shards:
            with on_device(dev):
                sw, sp, sq, spp, spq = moments(*(shard_rows(x, n_shards, shards).to(dev) for x in (p, q, w)))
                parts.append(torch.cat([sw[:, None], sp, sq, spp[:, None], spq.flatten(1)], dim=1).to(mesh[0]))
    local = torch.cat(parts) if parts else torch.zeros((0, MOMENT_COLUMNS), dtype=torch.float64, device=mesh[0])
    # the rows arrive by global entry (ranks outer), each entry's shards ascending
    arrival = sorted(range(n_shards), key=lambda j: (entry_of[j], j))
    partials = multihost.all_gather_rows(local)[torch.as_tensor(arrival).argsort().to(mesh[0])]
    m = tree_sum(partials.T).cpu().numpy()
    return solve_from_moments(m[0], m[1:4], m[4:7], m[7], m[8:17].reshape(3, 3))
