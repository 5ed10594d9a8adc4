"""Reference extraction under featExtract's -w: the scan resampled to the
isotropic grid of its smallest voxel size, the features of
``extract.features`` on it, and its rows in world millimetres.

``resample`` is written from the description of featExtract's -w
(featExtract.cpp:118-204) and of fioGetPixelTrilinearInterp
(FeatureIO.cpp:813-852). The grid: along an axis of n voxels of size d, n *
d / min(d) samples (truncated), sample i at i * (min(d) / d) + 0.5 input
voxels, in f32 (the spacing rounded to f32). A voxel's centre lies at its
index + 0.5; a sample takes its two neighbouring centres c and c + 1 along
each axis, with the weight 1 - (p - 0.5 - c) on c, and saturates at the
border: below the first centre it is the first voxel, at or past the last
one the last voxel. The three axes are interpolated one after another, x,
then y, then z, each an f32 product and sum: the trilinear value.

``to_world`` is written from Feature3DInfo::SimilarityTransform
(MultiScale.cpp:87-125) and featExtract.cpp:162-176, 507-538: the world
matrix of the resampled grid is the header's with each column times min(d)
/ d; a row's location goes through it, its scale times the mean of the
matrix's row norms, its orientation's columns through the matrix's rows
normalised, in f64, stored in f32.

It imports neither the JAX package nor the program. ``control=True``: the
blur in TF32, as in ``extract.features``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import extract

f32 = np.float32


def grid_shape(shape_zyx, voxel_size_xyz) -> tuple:
    """The [Z, Y, X] of the isotropic grid of a scan of voxel size (dx, dy, dz)."""
    d = [float(v) for v in voxel_size_xyz][::-1]  # z, y, x
    dmin = min(d)
    return tuple(int(int(n) * di / dmin) for n, di in zip(shape_zyx, d))


def _along(t: torch.Tensor, axis: int, n_out: int, spacing: float) -> torch.Tensor:
    """t sampled along `axis` at n_out positions spacing apart from the
    first centre, with the saturating two-point rule."""
    n = t.shape[axis]
    p = torch.arange(n_out, dtype=torch.float32) * torch.tensor(spacing, dtype=torch.float32) + 0.5
    u = p - 0.5  # distance from the first centre, in voxels
    if n == 1:
        lo = hi = torch.zeros(n_out, dtype=torch.int64)
        w = torch.ones(n_out)
    else:
        lo = torch.clamp(torch.floor(u), 0, n - 2).to(torch.int64)
        hi = lo + 1
        w = 1.0 - (u - lo.to(torch.float32))
        w = torch.where(u < 0, torch.ones_like(w), w)
        w = torch.where(u >= n - 1, torch.zeros_like(w), w)
    shape = [1] * t.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    return w * t.index_select(axis, lo) + (1.0 - w) * t.index_select(axis, hi)


def resample(vol: np.ndarray, voxel_size_xyz) -> np.ndarray:
    """A [Z, Y, X] scan of voxel size (dx, dy, dz) on the isotropic grid of
    its smallest, f32; a scan of cubic voxels as it is (featExtract
    resamples only an anisotropic one)."""
    dx, dy, dz = (float(v) for v in voxel_size_xyz)
    t = torch.from_numpy(np.ascontiguousarray(vol, f32))
    if dx == dy == dz:
        return t.numpy()
    dmin = min(dx, dy, dz)
    oz, oy, ox = grid_shape(vol.shape, voxel_size_xyz)
    with torch.no_grad():
        t = _along(t, 2, ox, dmin / dx)
        t = _along(t, 1, oy, dmin / dy)
        t = _along(t, 0, oz, dmin / dz)
    return np.ascontiguousarray(t.numpy())


def grid_world(voxel_size_xyz, world) -> np.ndarray:
    """The voxel-to-world matrix of the isotropic grid: the header's, each
    column times min(d) / d."""
    d = np.array([float(v) for v in voxel_size_xyz])
    m = np.array(world, dtype=np.float64)
    m[:3, :3] = m[:3, :3] * (d.min() / d)[None, :]
    return m


def to_world(rows: dict, m: np.ndarray) -> dict:
    """Rows (``extract.features``' fields) in the grid's voxels, through the
    4x4 similarity m."""
    lin = m[:3, :3]
    norms = np.sqrt((lin * lin).sum(1))
    rot = lin / norms[:, None]
    xyz = rows["xyz"].astype(np.float64) @ lin.T + m[:3, 3]
    ori = np.matmul(rows["ori"].astype(np.float64), rot.T)
    return dict(rows, xyz=xyz.astype(f32), scale=(rows["scale"] * norms.mean()).astype(f32), ori=ori.astype(f32))


def features(vol: np.ndarray, voxel_size_xyz, world, sift: dict, descriptor: str, control: bool = False) -> dict:
    """The features of one [Z, Y, X] scan under -w (``extract.features``'
    fields), in world millimetres."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = extract.features(resample(vol, voxel_size_xyz), sift, descriptor, control=control)
    return to_world(rows, grid_world(voxel_size_xyz, world))
