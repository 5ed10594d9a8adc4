"""Several processes: volumes spread over processes, one exchange of
keypoint sets, and the sharded matching and solve spanning the processes.

The port's counterpart of ``sift3d.dist.multihost`` on ``torch.distributed``:

- every process calls :func:`initialize`, which joins a process group
  (gloo, over host tensors). The JAX package's one exchange is
  ``process_allgather`` of host numpy tables, and gloo moves host tensors
  the same way; it also lets several processes share one card, which NCCL
  refuses;
- volumes are dealt round-robin over the processes (:func:`my_volume_ids`),
  and each process extracts its share on its own devices by placement
  (``dist.batch.extract_features_batch``): no bytes move between processes
  during extraction;
- the keypoint sets are exchanged once (:func:`gather_featuresets`), after
  which every process holds them all, and ``dist.gather.sharded_knn`` and
  ``dist.solve.solve_similarity_sharded`` span the process group: rank r
  takes the r-th share, and the small results are all-gathered in rank
  order, so every process ends with the single-process result, bit for bit.

The ranks are the outer axis of the global mesh: a process's local mesh is
its own devices (:func:`global_mesh`). Nothing here discovers a cluster:
the address, the world size and the rank come from the arguments or from
SIFT3D_COORDINATOR, SIFT3D_NUM_PROCESSES and SIFT3D_PROCESS_ID.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.dist.batch import extract_features_batch
from sift3d_torch.dist.mesh import make_mesh

TABLE_COLUMNS = 84  # xyz 3 + scale 1 + ori 9 + eigs 3 + info 1 + desc 64 + pad 3


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or form) the process group; idempotent.

    coordinator_address: "host:port" (rank 0 listens there) or an init URL
    such as "tcp://host:port" or "file:///shared/path"; with the world size
    and this process's rank, from the arguments or else from
    SIFT3D_COORDINATOR, SIFT3D_NUM_PROCESSES and SIFT3D_PROCESS_ID."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("SIFT3D_COORDINATOR")
    if num_processes is None and "SIFT3D_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SIFT3D_NUM_PROCESSES"])
    if process_id is None and "SIFT3D_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SIFT3D_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of processes and this "
            "process's id (arguments, or SIFT3D_COORDINATOR / SIFT3D_NUM_PROCESSES / SIFT3D_PROCESS_ID)"
        )
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init, world_size=num_processes, rank=process_id)


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's [n_r, ...] tensor concatenated in rank order, on t's
    device (through host memory; rows may differ in number between ranks)."""
    _, size = world()
    if size == 1:
        return t
    host = t.detach().cpu().contiguous()
    n = torch.tensor([host.shape[0]], dtype=torch.int64)
    counts = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    padded = torch.zeros((max(counts), *host.shape[1:]), dtype=host.dtype)
    padded[: host.shape[0]] = host
    parts = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(parts, padded)
    return torch.cat([part[:c] for part, c in zip(parts, counts)]).to(t.device)


def global_mesh() -> List[torch.device]:
    """This process's CUDA devices, in order (raises without one). Across
    processes the ranks are the outer axis."""
    return make_mesh()


def my_volume_ids(n_volumes: int) -> List[int]:
    """Round-robin ownership of a shared volume list for this process."""
    rank, size = world()
    return list(range(rank, n_volumes, size))


def extract_features_multihost(
    vols: Sequence, cfg: SiftConfig = DEFAULT_CONFIG, mesh: Optional[Sequence] = None, **kw,
) -> List[Optional[FeatureSet]]:
    """Each process extracts its share of `vols` (the same list on every
    process) by placement over its local mesh (None: :func:`global_mesh`);
    kw as in ``extract_features_batch``. Returns a full-length list with
    this process's results and None elsewhere; follow with
    :func:`gather_featuresets`."""
    ids = my_volume_ids(len(vols))
    out: List[Optional[FeatureSet]] = [None] * len(vols)
    if not ids:
        return out
    mesh = global_mesh() if mesh is None else mesh
    for i, f in zip(ids, extract_features_batch([vols[i] for i in ids], mesh, cfg, **kw)):
        out[i] = f
    return out


def gather_featuresets(partial_sets: Sequence[Optional[FeatureSet]]) -> List[FeatureSet]:
    """Replicate every process's FeatureSets to every process: the one
    exchange of the pipeline.

    Each process marks the volumes it owns (its non-None entries) and the
    rows of each; the processes agree on that table first, and every volume
    must have exactly one owner (anything else is a caller's error, raised
    on every process alike). Then each process sends its owned sets as one
    flat [rows, 84] f32 table (:func:`pack`), and every process unpacks the
    owner's rows of each volume."""
    rank, size = world()
    n_vol = len(partial_sets)
    tables = [pack(fs) for fs in partial_sets if fs is not None]
    mine = torch.tensor(
        [[len(fs) if fs is not None else 0, int(fs is not None)] for fs in partial_sets], dtype=torch.int64
    ).reshape(n_vol, 2)
    counts = all_gather_rows(mine).reshape(size, n_vol, 2)
    owners = counts[:, :, 1].sum(0)
    bad = torch.nonzero(owners != 1).flatten().tolist()
    if bad:
        i = bad[0]
        raise ValueError(
            f"volume {i}: expected exactly one owning process, got {int(owners[i])} "
            f"(ownership flags {counts[:, i, 1].tolist()})"
        )
    local = torch.from_numpy(np.concatenate(tables)) if tables else torch.zeros((0, TABLE_COLUMNS))
    flat = all_gather_rows(local).numpy()
    # rank r's table holds its volumes in volume order; walk the ranks in order
    start = np.concatenate([[0], np.cumsum(counts[:, :, 0].sum(1).numpy())])
    out: List[FeatureSet] = []
    cursor = start[:-1].copy()
    owner = counts[:, :, 1].argmax(0).tolist()
    for i in range(n_vol):
        r, n = owner[i], int(counts[owner[i], i, 0])
        out.append(unpack(flat[cursor[r] : cursor[r] + n]))
        cursor[r] += n
    return out


def pack(fs: FeatureSet) -> np.ndarray:
    """A FeatureSet as the [N, 84] f32 exchange table (info as f32: the
    flags are small integers, exact in f32)."""
    t = np.zeros((len(fs), TABLE_COLUMNS), np.float32)
    t[:, 0:3] = fs.xyz
    t[:, 3] = fs.scale
    t[:, 4:13] = fs.ori.reshape(len(fs), 9)
    t[:, 13:16] = fs.eigs
    t[:, 16] = fs.info.astype(np.float32)
    t[:, 17:81] = fs.desc
    return t


def unpack(t: np.ndarray) -> FeatureSet:
    fs = FeatureSet.empty(t.shape[0])
    fs.xyz = t[:, 0:3].copy()
    fs.scale = t[:, 3].copy()
    fs.ori = t[:, 4:13].reshape(-1, 3, 3).copy()
    fs.eigs = t[:, 13:16].copy()
    fs.info = t[:, 16].astype(fs.info.dtype)
    fs.desc = t[:, 17:81].copy()
    return fs
