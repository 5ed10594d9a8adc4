"""GoH-64 descriptor with rank normalization.

PyTorch port of ``sift3d.kernels.descriptor`` (descriptor.py:32-117).
Reference equivalents:
- msResampleFeaturesGradientOrientationHistogram (MultiScale.cpp:583-710):
  8 orientation bins (cube-corner directions) x 2x2x2 spatial bins = 64-d,
  trilinear spatial splatting, positive-shift L2 normalization
  (msNormalizeDataPositive, MultiScale.cpp:1580-1611).
- Feature3DInfo::NormalizeDataRankedPCs (MultiScale.cpp:207-233): values
  replaced by their ascending sort rank (ties broken by index).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sift3d_torch.core.numerics import sqrt
from sift3d_torch.kernels.patch import PATCH_DIM, patch_gradients

# 8 orientation bin directions: cube corners (MultiScale.cpp:616-626)
ORI_DIRS = np.array(
    [
        [1, 1, 1],
        [1, 1, -1],
        [1, -1, 1],
        [1, -1, -1],
        [-1, 1, 1],
        [-1, 1, -1],
        [-1, -1, 1],
        [-1, -1, -1],
    ],
    dtype=np.float32,
)
ORI_DIRS.setflags(write=False)


@functools.lru_cache(maxsize=None)
def spatial_weight_table() -> np.ndarray:
    """[11, 2] per-axis trilinear splat weights onto the 2-bin grid
    (MultiScale.cpp:639-671): positions 0..4 -> bin 0; position 5 ->
    half/half; 6..10 -> bin 1. Read-only."""
    bin_size = PATCH_DIM / 2.0  # 5.5
    w = np.zeros((PATCH_DIM, 2), dtype=np.float32)
    for v in range(PATCH_DIM):
        coord = int(v / bin_size) + 0.5
        if int(v / bin_size) != int((v + 1) / bin_size):
            coord = (v / bin_size + (v + 1) / bin_size) / 2.0
        # interp onto 2-voxel axis, 0.5-center convention
        if coord < 0.5:
            i, wt = 0, 1.0
        elif coord >= 1.5:
            i, wt = 0, 0.0
        else:
            i = int(math.floor(coord - 0.5))
            wt = 1.0 - (coord - 0.5 - i)
        w[v, i] += wt
        if i + 1 < 2:
            w[v, i + 1] += 1.0 - wt
    w.setflags(write=False)
    return w


def goh_descriptor(patches_norm: torch.Tensor) -> torch.Tensor:
    """64-d gradient orientation histogram for normalized patches.

    Returns [C, 64] with reference memory layout: index =
    ((zbin*2 + ybin)*2 + xbin)*8 + oribin (MultiScale.cpp:630-637).
    """
    grads = patch_gradients(patches_norm)  # [C, 3(dx,dy,dz), z, y, x]
    gx, gy, gz = grads[:, 0], grads[:, 1], grads[:, 2]
    mag = sqrt(gx * gx + gy * gy + gz * gz)  # [C, z, y, x]
    # orientation bin: max dot of the edge with cube corners; argmax picks
    # the first max like the reference scan (MultiScale.cpp:687-698)
    dots = torch.stack([gx * d[0] + gy * d[1] + gz * d[2] for d in ORI_DIRS.tolist()], dim=1)
    obin = torch.argmax(dots, dim=1)  # [C, z, y, x]
    onehot = torch.nn.functional.one_hot(obin, 8).to(mag.dtype)  # [C, z, y, x, 8]
    weighted = onehot * torch.where(mag > 0, mag, torch.zeros_like(mag))[..., None]
    wt = torch.from_numpy(spatial_weight_table().copy()).to(patches_norm.device)  # [11, 2]
    h = torch.einsum("czyxo,xd->czyod", weighted, wt)
    h = torch.einsum("czyod,yb->czbod", h, wt)
    h = torch.einsum("czbod,za->cabdo", h, wt)  # [C, 2, 2, 2, 8]
    return h.reshape(h.shape[0], 64)


def normalize_positive(desc: torch.Tensor) -> torch.Tensor:
    """Subtract min, scale to unit L2 (msNormalizeDataPositive)."""
    shifted = desc - desc.amin(dim=-1, keepdim=True)
    norm = sqrt((shifted * shifted).sum(dim=-1, keepdim=True))
    return shifted / torch.where(norm > 0, norm, torch.ones_like(norm))


def rank_normalize(desc: torch.Tensor) -> torch.Tensor:
    """Replace each value by its ascending sort rank, ties by index
    (NormalizeDataRankedPCs + _sortAscendingMVNature)."""
    order = torch.argsort(desc, dim=-1, stable=True)
    n = desc.shape[-1]
    ranks = torch.arange(n, dtype=desc.dtype, device=desc.device).expand_as(desc)
    return torch.zeros_like(desc).scatter(-1, order, ranks)
