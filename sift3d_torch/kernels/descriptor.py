"""GoH-64 descriptor with rank normalization, and the BRIEF family.

PyTorch port of ``sift3d.kernels.descriptor`` (descriptor.py:32-209).
Reference equivalents:
- msResampleFeaturesGradientOrientationHistogram (MultiScale.cpp:583-710):
  8 orientation bins (cube-corner directions) x 2x2x2 spatial bins = 64-d,
  trilinear spatial splatting, positive-shift L2 normalization
  (msNormalizeDataPositive, MultiScale.cpp:1580-1611).
- Feature3DInfo::NormalizeDataRankedPCs (MultiScale.cpp:207-233): values
  replaced by their ascending sort rank (ties broken by index).
- msResampleFeaturesBRIEF (MultiScale.cpp:989-1049): BRIEF / RRIEF /
  NRRIEF pair differences on the sigma-0.95 blurred patch, with the frozen
  pair tables of msGenerateBRIEFindex (MultiScale.cpp:743-956).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sift3d_torch.core.numerics import sqrt, tree_sum
from sift3d_torch.kernels import gauss_cuda
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
    ((zbin*2 + ybin)*2 + xbin)*8 + oribin (MultiScale.cpp:630-637). The
    splat contracts x, then y, then z, each an ascending chain of separately
    rounded multiply-adds from 0, as the fused kernel (``csrc/
    rotated_goh.cu``) does; a library einsum would pick its own order.
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

    def chain(slices, shape):
        # sum over k ascending, from 0, of slices[k] * wt[k] (wt[k]'s two
        # bins laid out as `shape`)
        acc = 0.0
        for k, s in enumerate(slices):
            acc = acc + s * wt[k].reshape(shape)
        return acc

    h = chain([w[..., None] for w in weighted.unbind(3)], (2,))  # [C, z, y, o, d]
    h = chain([s[:, :, None] for s in h.unbind(2)], (1, 1, 2, 1, 1))  # [C, z, b, o, d]
    h = chain([s[:, None] for s in h.unbind(1)], (1, 2, 1, 1, 1))  # [C, a, b, o, d]
    return h.permute(0, 1, 2, 4, 3).reshape(h.shape[0], 64)  # [C, a, b, d, o]


def normalize_positive(desc: torch.Tensor) -> torch.Tensor:
    """Subtract min, scale to unit L2 (msNormalizeDataPositive); the norm's
    sum is a :func:`tree_sum`, as in the fused kernel."""
    shifted = desc - desc.amin(dim=-1, keepdim=True)
    norm = sqrt(tree_sum(shifted * shifted))[..., None]
    return shifted / torch.where(norm > 0, norm, torch.ones_like(norm))


def rank_normalize(desc: torch.Tensor) -> torch.Tensor:
    """Replace each value by its ascending sort rank, ties by index
    (NormalizeDataRankedPCs + _sortAscendingMVNature). Ties are common (a
    shifted GoH row has at least one 0), so the tie order is the contract:
    the fused K4 counts the same place as #{j: v_j < v_i} + #{j < i: v_j ==
    v_i}."""
    order = torch.argsort(desc, dim=-1, stable=True)
    n = desc.shape[-1]
    ranks = torch.arange(n, dtype=desc.dtype, device=desc.device).expand_as(desc)
    return torch.zeros_like(desc).scatter(-1, order, ranks)


# ---------------------------------------------------------------------------
# BRIEF / RRIEF / NRRIEF
# ---------------------------------------------------------------------------

# Frozen pseudo-random pair tables (data constants reproduced from
# msGenerateBRIEFindex, MultiScale.cpp:743-956, for bit-parity with the
# reference; the live RNG code there is commented out with seeds 5/8).
# Layout: 64 triplets (x, y, z) per endpoint.
_BRIEF_TABLES = {
    0: (
        [4,6,2,2,2,2,4,3,8,7,3,2,2,6,3,3,5,8,6,7,5,5,7,4,6,6,3,2,6,8,2,7,2,6,6,7,7,8,8,6,3,2,4,5,5,4,7,7,5,7,4,3,7,2,2,3,8,3,2,4,3,5,4,3,4,2,6,6,5,8,2,3,3,4,7,8,3,2,2,7,3,5,4,5,6,5,6,7,6,8,4,8,4,5,8,5,6,3,6,5,3,7,6,3,8,6,8,2,8,2,8,3,2,3,3,5,3,7,8,3,4,4,5,5,3,2,8,7,6,5,3,6,4,2,4,2,7,5,4,6,7,3,5,4,3,5,2,6,3,2,8,4,4,6,5,4,8,7,2,8,6,5,2,7,5,7,4,2,5,7,4,7,7,4,8,8,2,8,3,4,6,7,5,8,2,4,6,3,8,6,5,4],
        [5,2,3,7,5,8,7,5,6,5,6,3,2,7,4,6,2,8,4,6,6,3,5,7,7,4,3,3,4,8,8,5,3,4,2,6,8,3,3,3,7,8,6,2,6,6,2,5,2,7,8,6,2,7,4,3,8,4,7,7,3,3,8,2,5,2,7,2,4,5,8,3,5,6,3,2,8,2,4,6,7,3,2,4,4,7,4,4,8,8,5,8,2,8,8,5,3,3,5,6,7,4,8,4,8,7,4,7,3,4,6,7,5,2,8,7,6,5,8,7,8,7,8,6,8,4,8,4,5,7,4,8,2,3,8,2,5,4,3,2,8,8,7,3,5,7,4,5,4,6,6,7,7,8,6,8,4,2,6,7,5,4,2,8,8,6,5,8,4,4,4,6,6,4,5,3,4,5,4,4,8,4,3,4,6,5,8,7,7,2,2,3],
    ),
    1: (
        [5,4,4,6,5,5,3,8,5,5,6,3,5,6,5,6,3,4,3,4,5,4,5,4,5,5,5,5,6,5,5,5,5,3,5,7,3,5,5,5,6,6,5,3,6,5,5,5,4,5,5,5,3,5,4,4,6,6,4,3,5,3,3,3,6,6,4,4,5,5,5,5,4,4,5,6,5,4,4,4,4,3,4,4,6,3,2,5,4,4,5,4,3,6,7,5,3,5,4,5,5,4,5,6,3,5,6,5,5,6,5,5,7,6,4,4,6,6,4,4,4,5,2,5,4,5,2,5,5,5,2,6,3,3,5,4,7,5,4,5,3,5,4,6,4,4,3,4,5,4,6,3,4,5,5,6,4,3,4,6,4,4,6,5,4,4,5,5,5,5,4,4,3,7,7,3,6,6,5,7,4,6,2,4,2,5,6,3,3,6,5,6],
        [4,4,2,4,4,4,5,6,4,5,5,5,4,6,6,4,4,5,4,5,5,4,6,4,4,2,7,7,5,3,5,4,5,4,5,4,2,3,5,4,5,5,4,5,5,4,6,5,4,4,6,4,5,5,3,6,4,6,4,4,7,4,5,4,4,2,5,4,6,4,3,5,3,4,7,5,2,4,4,6,3,4,6,5,6,4,4,5,5,3,4,5,4,5,5,5,4,5,5,4,5,4,5,3,4,6,4,5,3,6,5,4,4,6,4,7,4,4,3,6,4,3,7,4,5,6,2,3,6,5,5,5,5,4,4,5,3,4,6,4,5,5,4,2,4,4,4,6,4,6,6,3,6,5,5,3,3,5,5,3,5,3,4,2,3,6,2,4,5,4,7,3,4,3,3,5,4,3,5,4,4,4,6,3,5,4,3,5,7,5,4,4],
    ),
    2: (
        [5,4,4,4,4,2,6,5,5,4,4,4,3,8,5,5,6,3,5,5,5,5,6,5,4,6,6,6,3,4,4,4,5,3,4,5,4,5,5,4,2,7,7,5,3,5,4,5,3,5,7,3,5,5,2,3,5,5,6,6,4,6,5,4,4,6,5,3,5,6,4,3,6,4,4,5,3,3,3,6,6,5,2,4,4,6,3,6,3,2,3,5,4,5,3,4,3,6,5,4,3,6,4,5,2,4,3,7,2,3,6,5,2,6,3,3,5,6,3,6,3,5,3,6,5,7,4,2,5,5,5,2,5,7,4,2,5,3,4,3,3,7,4,4,7,6,4,4,2,8,7,6,5,4,7,3,6,6,5,2,4,5,3,2,5,5,1,6,3,6,3,6,2,5,4,4,7,2,6,3,2,2,4,3,3,2,3,4,2,5,6,7],
        [6,5,3,4,5,3,7,4,6,4,3,2,4,7,5,3,5,1,5,4,7,6,8,4,4,5,6,5,2,5,4,6,4,0,4,3,3,4,4,2,1,7,8,6,4,4,1,6,1,3,7,2,3,3,1,3,6,1,6,6,4,7,6,4,3,5,4,2,3,6,4,5,6,3,3,5,1,3,1,6,7,4,1,4,3,5,2,4,2,1,2,5,4,5,2,3,3,3,3,4,2,6,3,4,3,3,3,6,1,2,5,4,2,4,1,4,6,7,3,6,2,4,3,6,5,6,4,0,6,6,5,1,4,7,2,1,5,3,4,2,2,7,3,3,6,4,2,4,1,9,7,7,5,2,7,1,7,5,5,1,5,4,1,3,3,4,0,5,1,6,3,5,3,2,3,3,7,2,5,1,1,0,4,1,3,1,0,3,1,6,5,9],
    ),
    3: (
        None,  # first endpoint is the patch center (5,5,5)
        [6,4,6,3,4,6,5,4,6,4,6,4,6,3,4,4,6,2,5,5,4,5,3,4,6,5,4,4,5,4,4,4,4,5,4,5,3,5,4,3,3,4,6,7,5,6,4,7,4,4,6,5,4,4,4,3,4,5,6,4,5,3,7,5,4,3,2,5,5,3,4,4,4,5,6,5,6,3,4,3,2,4,6,3,3,4,3,4,4,3,5,3,5,4,4,5,1,6,5,4,5,5,5,6,6,5,4,2,5,5,6,5,7,4,3,5,3,4,3,7,3,7,5,3,6,4,6,4,4,6,3,5,6,4,5,5,7,5,2,4,3,7,6,5,7,4,6,6,5,5,4,5,3,4,3,5,5,5,3,5,3,3,4,6,5,6,6,6,6,6,5,4,2,4,6,6,3,3,5,5,7,3,4,4,4,2,4,6,6,5,6,5],
    ),
    4: (
        None,
        [5,5,4,5,5,6,2,8,5,6,2,4,5,6,9,2,5,5,6,5,8,5,4,1,4,5,9,2,5,3,4,4,5,5,3,2,7,5,3,5,7,4,5,5,2,6,6,2,4,5,4,7,7,6,6,1,5,5,7,3,5,5,3,4,5,7,6,4,8,8,8,4,6,4,7,4,7,5,5,6,3,5,7,5,4,3,7,4,7,2,5,4,2,5,6,5,5,5,1,5,4,6,6,5,4,3,5,6,6,5,7,2,4,5,5,4,3,7,3,4,5,5,9,1,5,4,8,5,7,2,5,2,5,5,7,4,5,2,5,7,8,3,3,2,4,6,5,5,3,5,7,6,5,5,4,7,6,3,5,5,5,8,9,4,5,7,5,5,6,7,3,4,5,5,3,5,8,6,5,3,6,1,3,3,4,3,5,6,4,3,4,5],
    ),
}


@functools.lru_cache(maxsize=None)
def brief_pair_table(method: int = 2):
    """(p, q) int32 arrays [64, 3] of (x, y, z) voxel pairs, read-only.

    method 0: uniform; 1: iso-Gaussian; 2: Gaussian pair-centered (default);
    3: center-to-Gaussian (p is the patch centre); 4: polar grid.
    """
    t0, t1 = _BRIEF_TABLES[method]
    q = np.asarray(t1, dtype=np.int32).reshape(-1, 3)
    if t0 is None:
        p = np.full(q.shape, PATCH_DIM // 2, dtype=np.int32)
    else:
        p = np.asarray(t0, dtype=np.int32).reshape(-1, 3)
    p.setflags(write=False)
    q.setflags(write=False)
    return p, q


BRIEF_VARIANTS = ("brief", "rrief", "nrrief")


@functools.lru_cache(maxsize=None)
def brief_pairs(method: int, device: torch.device):
    """The pair table of `method` on `device`, made once a device and shared
    by the plain version and the fused kernel: (flat voxel indices int32
    [2, 64], z * 121 + y * 11 + x of each pair's p, then of its q; NRRIEF's
    divisors max(int(|p - q|), 1) as f32 [64])."""
    p, q = brief_pair_table(method)
    # table entries are (x, y, z); patches are [C, z, y, x]
    flat = np.stack([(t[:, 2] * PATCH_DIM + t[:, 1]) * PATCH_DIM + t[:, 0] for t in (p, q)]).astype(np.int32)
    dist = np.maximum(np.sqrt(((p - q) ** 2).sum(axis=1)).astype(np.int32), 1).astype(np.float32)
    return torch.from_numpy(flat).to(device), torch.from_numpy(dist).to(device)


def brief_descriptor(
    patches_norm: torch.Tensor, variant: str = "rrief", method: int = 2, blur_sigma: float = 0.95,
) -> torch.Tensor:
    """BRIEF family descriptor of normalized patches [C, 11, 11, 11];
    returns [C, 64] f32.

    The patches are blurred with sigma 0.95 (truncation 0.01, zero
    borders; K7 on the card), then for each frozen pair (p, q): d = I(p) -
    I(q); BRIEF stores (d < 0), RRIEF the raw difference, NRRIEF d /
    max(int(|p - q|), 1) (the distance truncated to an integer, and
    guarded for identical points).
    """
    if variant not in BRIEF_VARIANTS:
        raise ValueError(f"unknown BRIEF variant: {variant}")
    blurred = gauss_cuda.blur3d(patches_norm.contiguous(), blur_sigma, 0.01).flatten(1)
    flat, dist = brief_pairs(method, blurred.device)
    d = blurred.index_select(1, flat[0]) - blurred.index_select(1, flat[1])
    if variant == "brief":
        return (d < 0).to(patches_norm.dtype)
    if variant == "rrief":
        return d
    return d / dist
