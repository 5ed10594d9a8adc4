"""featExtract's -2+ and -w on a batch: 2x linear upsampling and isotropic
trilinear resampling (CUDA kernels + plain forms).

:func:`double_size_batch` doubles a [B, Z, Y, X] f32 batch into a
preallocated [B, OZ, OY, OX] output (:func:`doubled_shape`): for a CUDA
tensor in one launch of ``csrc/double_size.cu``, which replaces no TPU
kernel (the JAX package doubles eagerly); for a CPU tensor volume by volume
through the plain chain ``resample.double_size``, which the kernel equals
bit for bit.

:func:`isotropic_resample_batch` resamples a [B, Z, Y, X] f32 batch of
volumes of one voxel size to the isotropic grid of the smallest
(``resample.isotropic_shape``): for a CUDA tensor in one launch of
``csrc/isotropic_resample.cu``, which replaces no TPU kernel (the JAX
package resamples eagerly); for a CPU tensor volume by volume through the
plain chain ``resample.isotropic_resample``, which the kernel equals bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.resample import double_size, isotropic_resample


def doubled_shape(shape_zyx) -> tuple:
    """The [Z, Y, X] of a doubled volume: 2n along an axis of n > 1, n
    along an axis of length 1 (``resample.double_size``)."""
    return tuple(2 * int(n) if n > 1 else int(n) for n in shape_zyx)


def double_size_batch(batch: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write the doubled volumes of a contiguous f32 [B, Z, Y, X] batch into
    out, a contiguous f32 [B, *doubled_shape] tensor on the same device;
    returns out."""
    want = (batch.shape[0],) + doubled_shape(batch.shape[1:])
    if batch.ndim != 4 or tuple(out.shape) != want:
        raise ValueError(f"expected a [B, Z, Y, X] batch and a {want} output, got "
                         f"{tuple(batch.shape)} and {tuple(out.shape)}")
    if cuda_lib.route(batch) == "plain":
        for b in range(batch.shape[0]):
            out[b] = double_size(batch[b])
        return out
    cuda_lib.require_cuda(batch, "batch", torch.float32, 4)
    cuda_lib.require_cuda(out, "out", torch.float32, 4)
    if out.device != batch.device:
        raise ValueError(f"out on {out.device}, batch on {batch.device}")
    if batch.numel() == 0:
        return out
    cuda_lib.launch("sift3d_double_size", batch, out, *batch.shape, device=batch.device)
    return out


def isotropic_resample_batch(batch: torch.Tensor, out: torch.Tensor, voxel_size) -> torch.Tensor:
    """Write a contiguous f32 [B, Z, Y, X] batch of volumes of voxel size
    (dx, dy, dz), resampled to the grid of out (a contiguous f32 [B, OZ,
    OY, OX] tensor on the same device; ``resample.isotropic_shape`` for
    featExtract's -w), into out; returns out."""
    if batch.ndim != 4 or out.ndim != 4 or out.shape[0] != batch.shape[0] or 0 in out.shape[1:]:
        raise ValueError(f"expected a [B, Z, Y, X] batch and a [B, OZ, OY, OX] output, got "
                         f"{tuple(batch.shape)} and {tuple(out.shape)}")
    if cuda_lib.route(batch) == "plain":
        for b in range(batch.shape[0]):
            out[b] = isotropic_resample(batch[b], voxel_size, tuple(out.shape[:0:-1]))[0]
        return out
    cuda_lib.require_cuda(batch, "batch", torch.float32, 4)
    cuda_lib.require_cuda(out, "out", torch.float32, 4)
    if out.device != batch.device:
        raise ValueError(f"out on {out.device}, batch on {batch.device}")
    if batch.numel() == 0:
        return out
    # each axis's sample spacing in its input voxels, min / d, rounded to
    # f32 as isotropic_resample rounds it; z, y, x
    dmin = min(float(d) for d in voxel_size)
    factors = [float(np.float32(dmin / float(d))) for d in voxel_size[::-1]]
    cuda_lib.launch("sift3d_isotropic_resample", batch, out, *batch.shape, *out.shape[1:], *factors,
                    device=batch.device)
    return out
