"""Weighted similarity fit over inlier correspondences (``--refine``).

The reference estimates each pairwise transform from a single Hough-winning
hypothesis (featMatchUtilities.cpp:816-1025); the JAX package adds a
weighted least-squares similarity fit (Umeyama/Procrustes) over the Hough
inliers, from second-order moments (``sift3d.dist.solve.solve_similarity``;
its sharded form, ``sift3d_torch.dist.solve.solve_similarity_sharded``,
gives the same bits). Here the moments are f64 sums of the f32 points on
the device, in ``numerics.tree_sum``'s order, the same on every device, and
the 3 x 3 solve runs in f64 on the host, so the card and the CPU give the
same transform. The JAX package computes all of it in f32: its moments
cancel (E[q p^T] - qbar pbar^T over points about 5 voxels apart, some 40
voxels from the origin), so its translations sit up to about 1.5e-4 voxel
from an f64 replay on the test fixtures, while the port's sit within
1e-9 of it (``tests/test_torch_featmatch_cli.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.numerics import tree_sum


def moments(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Weighted moments (sw, sp [3], sq [3], spp, spq [3, 3] = sum w q p^T)
    of [..., N, 3] f64 points p, q and [..., N] f64 weights w, each a
    tree_sum over N (leading dims: a batch of point sets, one sum each)."""
    wp = w[..., None] * p
    sw = tree_sum(w)
    sp = tree_sum(wp.transpose(-1, -2))
    sq = tree_sum((w[..., None] * q).transpose(-1, -2))
    spp = tree_sum(w * ((p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]))
    spq = tree_sum((q[..., :, :, None] * wp[..., :, None, :]).movedim(-3, -1))
    return sw, sp, sq, spp, spq


def solve_from_moments(sw, sp, sq, spp, spq):
    """Closed-form weighted Umeyama (float64 numpy): (scale, rot [3, 3],
    trans [3]) minimizing sum w |s R p + t - q|^2."""
    sw = max(float(sw), 1e-20)
    pbar = np.asarray(sp, np.float64) / sw
    qbar = np.asarray(sq, np.float64) / sw
    cov = np.asarray(spq, np.float64) / sw - np.outer(qbar, pbar)  # E[q p^T] - qbar pbar^T
    varp = float(spp) / sw - float(pbar @ pbar)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.array([1.0, 1.0, d])
    rot = (u * diag[None, :]) @ vt
    scale = float((s * diag).sum() / max(varp, 1e-20))
    trans = qbar - scale * (rot @ pbar)
    return scale, rot, trans


def as_points(p, q, w, dev: torch.device):
    """p, q [N, 3] and w [N] (numpy arrays or tensors; w None: every weight
    1) as f64 tensors on dev, each value first rounded to f32."""
    p = torch.as_tensor(p, dtype=torch.float32, device=dev).double()
    q = torch.as_tensor(q, dtype=torch.float32, device=dev).double()
    if w is None:
        return p, q, torch.ones(p.shape[0], dtype=torch.float64, device=dev)
    return p, q, torch.as_tensor(w, dtype=torch.float32, device=dev).double()


def solve_similarity(p, q, w=None, device=None):
    """Weighted similarity fit p -> q of [N, 3] points with [N] weights
    (numpy arrays or tensors; w None: every weight 1): (scale, rot [3, 3],
    trans [3]) in f64. device: None means the card (raises without one)."""
    p, q, w = as_points(p, q, w, resolve_device(device, like=p))
    return solve_from_moments(*(m.cpu().numpy() for m in moments(p, q, w)))
