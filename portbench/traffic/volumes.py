"""Seeded blob-texture volumes on the T1 grid, made on the device.

A torch copy of the port's numpy generator
(``sift3d_torch/utils/synthetic.synthetic_blob_texture``, itself the JAX
package's bench volume): a broad ellipsoidal background plus n_blobs
Gaussian blobs of random centre, width and signed amplitude. Volume i of a
run comes from seed ``seed * 1000 + i`` with its own blobs, so the volumes
of a cohort are distinct subjects, not shifted copies. The numpy original
takes seconds a volume on the host; here the blobs' parameters are drawn
by a ``torch.Generator`` on the device and the texture is one matmul, then
each volume is copied once to host memory as an f32 numpy array, the form
in which a NIfTI reader hands a volume to its caller.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

SEED_STRIDE = 1000


def volume_seed(seed: int, i: int) -> int:
    return int(seed) * SEED_STRIDE + int(i)


def blob_texture(dims: Sequence[int], seed: int, n_blobs: int, device) -> torch.Tensor:
    """One [Z, Y, X] f32 texture on `device`, a function of (dims, seed,
    n_blobs, device type) only."""
    dev = torch.device(device)
    dz, dy, dx = (int(d) for d in dims)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    f32 = dict(dtype=torch.float32, device=dev)
    size = torch.tensor([dz, dy, dx], **f32)
    centers = (0.2 + 0.6 * torch.rand((n_blobs, 3), generator=gen, **f32)) * size
    sigmas = 1.5 + 4.5 * torch.rand((n_blobs,), generator=gen, **f32)
    amps = -150.0 + 400.0 * torch.rand((n_blobs,), generator=gen, **f32)
    z, y, x = (torch.arange(d, **f32) for d in (dz, dy, dx))
    c = size / 2
    r2 = (
        ((z[:, None, None] - c[0]) / (0.45 * dz)) ** 2
        + ((y[None, :, None] - c[1]) / (0.45 * dy)) ** 2
        + ((x[None, None, :] - c[2]) / (0.45 * dx)) ** 2
    )
    vol = 400.0 * torch.exp(-2.0 * r2)
    inv2s2 = (1.0 / (2.0 * sigmas * sigmas))[:, None]
    ez = amps[:, None] * torch.exp(-((z[None, :] - centers[:, 0:1]) ** 2) * inv2s2)
    ey = torch.exp(-((y[None, :] - centers[:, 1:2]) ** 2) * inv2s2)
    ex = torch.exp(-((x[None, :] - centers[:, 2:3]) ** 2) * inv2s2)
    plane = (ey[:, :, None] * ex[:, None, :]).reshape(n_blobs, dy * dx)
    vol += (ez.T @ plane).reshape(dz, dy, dx)
    return vol.contiguous()


def host_volumes(dims: Sequence[int], seed: int, count: int, n_blobs: int, device) -> List[np.ndarray]:
    """`count` distinct volumes (volume i from volume_seed(seed, i)), each
    made on `device` and copied once to host memory as a writable f32
    numpy array."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the same texture whatever the process set
    try:
        return [blob_texture(dims, volume_seed(seed, i), n_blobs, device).cpu().numpy() for i in range(count)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
