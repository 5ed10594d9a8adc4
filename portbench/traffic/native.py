"""Seeded blob-texture scans on a scanner's native, anisotropic grid, made
on the device.

The texture of ``traffic/volumes.py`` (a broad ellipsoidal background plus
n_blobs Gaussian blobs of random centre, width and signed amplitude), drawn
in millimetres and sampled at the voxel centres of a grid of voxel size
(dx, dy, dz): voxel i of an axis lies at i * d mm, so a blob of width s mm
spans s / d voxels along that axis (1.25x fewer along a 1.25 mm axis than
along a 1 mm one). The MNI generator is left as it is. Scan i of a run
comes from seed ``volume_seed(seed, i)`` with its own blobs; each scan is
copied once to host memory as an f32 numpy array.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from traffic.volumes import volume_seed


def native_texture(dims: Sequence[int], voxel_size_xyz: Sequence[float], seed: int, n_blobs: int,
                   device) -> torch.Tensor:
    """One [Z, Y, X] f32 texture on `device` of voxel size (dx, dy, dz) mm,
    a function of (dims, voxel size, seed, n_blobs, device type) only."""
    dev = torch.device(device)
    dz, dy, dx = (int(d) for d in dims)
    vx, vy, vz = (float(v) for v in voxel_size_xyz)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    f32 = dict(dtype=torch.float32, device=dev)
    extent = torch.tensor([dz * vz, dy * vy, dx * vx], **f32)  # mm, z y x
    centers = (0.2 + 0.6 * torch.rand((n_blobs, 3), generator=gen, **f32)) * extent
    sigmas = 1.5 + 4.5 * torch.rand((n_blobs,), generator=gen, **f32)
    amps = -150.0 + 400.0 * torch.rand((n_blobs,), generator=gen, **f32)
    z, y, x = (torch.arange(n, **f32) * v for n, v in ((dz, vz), (dy, vy), (dx, vx)))
    c = extent / 2
    r2 = (
        ((z[:, None, None] - c[0]) / (0.45 * extent[0])) ** 2
        + ((y[None, :, None] - c[1]) / (0.45 * extent[1])) ** 2
        + ((x[None, None, :] - c[2]) / (0.45 * extent[2])) ** 2
    )
    vol = 400.0 * torch.exp(-2.0 * r2)
    inv2s2 = (1.0 / (2.0 * sigmas * sigmas))[:, None]
    ez = amps[:, None] * torch.exp(-((z[None, :] - centers[:, 0:1]) ** 2) * inv2s2)
    ey = torch.exp(-((y[None, :] - centers[:, 1:2]) ** 2) * inv2s2)
    ex = torch.exp(-((x[None, :] - centers[:, 2:3]) ** 2) * inv2s2)
    plane = (ey[:, :, None] * ex[:, None, :]).reshape(n_blobs, dy * dx)
    vol += (ez.T @ plane).reshape(dz, dy, dx)
    return vol.contiguous()


def native_volumes(dims: Sequence[int], voxel_size_xyz: Sequence[float], seed: int, count: int, n_blobs: int,
                   device) -> List[np.ndarray]:
    """`count` distinct scans (scan i from volume_seed(seed, i)), each made
    on `device` and copied once to host memory as a writable f32 numpy
    array."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the same texture whatever the process set
    try:
        return [native_texture(dims, voxel_size_xyz, volume_seed(seed, i), n_blobs, device).cpu().numpy()
                for i in range(count)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
