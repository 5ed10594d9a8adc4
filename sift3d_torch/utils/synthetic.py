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


def extrema_edge_stack(shape, levels, seed, steps=((64, 32, 16, 8, 4, 2), (16, 8, 4), (30,))):
    """[levels, Z, Y, X] f32 inputs for the extrema mask at its edges: a
    smooth random field (strict extrema) whose y rows are rounded to quarter
    steps in every third band of three (plateaus and exact ties), with NaN,
    +inf, -inf, +0 and -0 planted on the seams of tiles of each size in
    steps (z runs, y rows, x columns: positions k * t, k * t + 1 and
    k * t + 2; by default csrc/dogs_extrema.cu's z runs, rows and 30-column
    warps) and on the volume's last two planes, rows and columns; plus, at
    a seam in the middle, a 3 x 3 x 3 cube of -0 in the first three levels
    around a +0 at level 1, and a cube of +inf in the last level."""
    rng = np.random.default_rng(seed)
    z, y, x = shape
    v = rng.standard_normal((levels, z, y, x))
    for axis in (1, 2, 3):
        for _ in range(2):
            v = (np.roll(v, 1, axis) + 2 * v + np.roll(v, -1, axis)) / 4
    v = v.astype(np.float32)
    band = (np.arange(y) // 3 % 3 == 0)[None, None, :, None]
    v = np.where(band, np.round(v * 4) / 4, v).astype(np.float32)

    def seams(d, ts):
        pos = {p for t in ts for k in range(d // t + 1) for p in (k * t, k * t + 1, k * t + 2)}
        return np.asarray(sorted(p for p in pos | {d - 2, d - 1} if 0 <= p < d))

    where = [seams(d, ts) for d, ts in zip(shape, steps)]
    n = max(4, v.size // 4000)
    for val in (np.nan, np.inf, -np.inf, 0.0, -0.0):
        idx = (rng.integers(0, levels, n),) + tuple(rng.choice(w, n) for w in where)
        v[idx] = val
    c = [min(max(int(w[len(w) // 2]), 1), d - 2) for w, d in zip(where, shape)]
    if min(shape) >= 3 and levels >= 3:
        box = tuple(slice(max(p - 1, 0), p + 2) for p in c)
        v[(slice(0, 3),) + box] = -0.0
        v[(1,) + tuple(c)] = 0.0
        v[(levels - 1,) + box] = np.inf
    return v
