"""Exact k-nearest-neighbour search on the card.

The reference uses FLANN kd-trees (8 trees / 64 checks, approximate;
feat_common/featMatchUtilities.cpp:1449-1456,1559). The JAX package
replaced them with exact brute force on the MXU (``sift3d.match.knn``:
``knn_search`` and its host tiling ``knn_search_tiled``, with power-of-two
shape buckets for XLA). The port streams the database through the kernel
M1 (``kernels.knn_cuda.knn_topk``) instead: no [Q, N] matrix, no tiles, no
buckets, and the same answer: the k smallest squared L2 distances,
ascending, the lowest index first among equal ones. Integer descriptor rows
go through its int8 tensor-core route, any others through f32 fma chains.
"""

from __future__ import annotations

import torch

from sift3d_torch.core.device import resolve_device
from sift3d_torch.kernels.knn_cuda import knn_topk


def knn_search(queries, db, k: int, device=None):
    """Exact kNN: (dist [Q, k] f32, idx [Q, k] int64) on the device, sorted
    ascending by (distance, index).

    queries [Q, C], db [N, C]: numpy arrays or tensors. device: None means
    the card (raises without one); "cpu" runs M1's plain version. An empty
    query set or database, or k = 0, gives zeros, as ``knn_search_tiled``
    does; k > N raises."""
    dev = resolve_device(device, like=queries)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev).contiguous()
    d = torch.as_tensor(db, dtype=torch.float32, device=dev).contiguous()
    n = d.shape[0]
    if q.shape[0] == 0 or n == 0 or k == 0:
        # empty query set or database (featureless images): no matches
        return (
            torch.zeros((q.shape[0], k), dtype=torch.float32, device=dev),
            torch.zeros((q.shape[0], k), dtype=torch.int64, device=dev),
        )
    if k > n:
        raise ValueError(f"k exceeds database size: k={k}, N={n}")
    return knn_topk(q, d, k)
