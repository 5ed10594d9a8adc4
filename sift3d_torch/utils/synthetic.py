"""Synthetic test volumes and the keypoint repeatability metric.

Copies of the generators in ``scripts/parity_vs_reference.py`` (numpy
only): ``synthetic_volume`` (:39), the sparse smoothed-blob fixture, and
``synthetic_blob_texture`` (:67), the dense blob texture of the benchmark
workload (``bench.py:23``, 182x218x182, the 1 mm MNI T1 grid). Same seeds
give the same volumes. ``repeatability`` (:122) is the pipeline-level
parity metric.
"""

from __future__ import annotations

import numpy as np

MNI_T1_DIMS = (182, 218, 182)


def synthetic_volume(dims=64, seed=3):
    """Sparse smoothed-blob volume; dims: int (cube) or (z, y, x)."""
    if isinstance(dims, int):
        dims = (dims, dims, dims)
    dz, dy, dx = dims
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:dz, 0:dy, 0:dx].astype(np.float32)
    vol = np.zeros(dims, np.float32)
    c = np.asarray(dims, np.float32) / 2
    r2 = (
        ((z - c[0]) / (0.45 * dz)) ** 2
        + ((y - c[1]) / (0.45 * dy)) ** 2
        + ((x - c[2]) / (0.45 * dx)) ** 2
    )
    vol += 300.0 * np.exp(-2.0 * r2)
    mean_dim = sum(dims) / 3.0
    for _ in range(max(6, int(mean_dim) // 4)):
        bc = rng.uniform(0.2, 0.8, 3) * np.asarray(dims)
        # blob size tracks volume size so halving stays detectable
        s = rng.uniform(2.0, 5.0) * max(1.0, mean_dim / 64.0)
        a = rng.uniform(-150, 250)
        m2 = (z - bc[0]) ** 2 + (y - bc[1]) ** 2 + (x - bc[2]) ** 2
        vol += a * np.exp(-m2 / (2 * s * s))
    return vol.astype(np.float32)


def synthetic_blob_texture(dims=MNI_T1_DIMS, seed=7, n_blobs=160):
    """Dense blob texture (~1k-2k features at 182x218x182)."""
    if isinstance(dims, int):
        dims = (dims, dims, dims)
    dz, dy, dx = dims
    rng = np.random.default_rng(seed)
    centers = (rng.uniform(0.2, 0.8, (n_blobs, 3)) * np.array(dims)).astype(np.float32)
    sigmas = rng.uniform(1.5, 6.0, n_blobs).astype(np.float32)
    amps = rng.uniform(-150, 250, n_blobs).astype(np.float32)

    z = np.arange(dz, dtype=np.float32)
    y = np.arange(dy, dtype=np.float32)
    x = np.arange(dx, dtype=np.float32)
    c = np.asarray(dims, np.float32) / 2
    r2 = (
        ((z[:, None, None] - c[0]) / (0.45 * dz)) ** 2
        + ((y[None, :, None] - c[1]) / (0.45 * dy)) ** 2
        + ((x[None, None, :] - c[2]) / (0.45 * dx)) ** 2
    )
    vol = 400.0 * np.exp(-2.0 * r2)
    inv2s2 = 1.0 / (2.0 * sigmas * sigmas)
    ez = amps[:, None] * np.exp(-((z[None, :] - centers[:, 0:1]) ** 2) * inv2s2[:, None])
    ey = np.exp(-((y[None, :] - centers[:, 1:2]) ** 2) * inv2s2[:, None])
    ex = np.exp(-((x[None, :] - centers[:, 2:3]) ** 2) * inv2s2[:, None])
    vol += np.einsum("nz,ny,nx->zyx", ez, ey, ex, optimize=True)
    return vol.astype(np.float32)


def repeatability(a, b, tol=2.0, scale_ratio=2 ** (1.0 / 3.0)):
    """Fraction of features in `a` with a geometric match in `b` (within
    tol voxels, scale ratio inside (1/scale_ratio, scale_ratio)); returns
    (fraction, index of the nearest match in b or -1)."""
    if len(a) == 0 or len(b) == 0:
        return 0.0, np.zeros(0, np.int64)
    d = np.linalg.norm(a.xyz[:, None, :] - b.xyz[None, :, :], axis=-1)
    sr = a.scale[:, None] / b.scale[None, :]
    ok = (d < tol) & (sr < scale_ratio) & (sr > 1.0 / scale_ratio)
    hit = ok.any(axis=1)
    nearest = np.where(hit, np.where(ok, d, np.inf).argmin(axis=1), -1)
    return float(hit.mean()), nearest
