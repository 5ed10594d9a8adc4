"""Volume resampling: 2x octave subsampling and the interpolation rule.

Reference equivalents:
- subsample_2x:  fioSubSampleInterpolate (FeatureIO.cpp:1475-1554): each
                 output voxel is the mean of its 8 children.
- interp_coord:  _fioDetermineInterpCoord (FeatureIO.cpp:752-781), the
                 0.5-voxel-center convention every sampler here shares;
                 interp_bin is the same rule at bin coordinates (the
                 orientation histograms).
"""

from __future__ import annotations

import torch


def subsample_2x(vol: torch.Tensor) -> torch.Tensor:
    """Halve each spatial dimension of a [..., Z, Y, X] volume; each output
    voxel = mean of the 2x2x2 block (odd trailing voxels are dropped, as in
    the reference where out dims are in/2). The reshape-mean form of
    ``sift3d.kernels.resample.subsample_2x``."""
    z, y, x = vol.shape[-3:]
    lead = tuple(vol.shape[:-3])
    z2, y2, x2 = z // 2, y // 2, x // 2
    v = vol[..., : 2 * z2, : 2 * y2, : 2 * x2]
    v = v.reshape(lead + (z2, 2, y2, 2, x2, 2))
    # the 8 children summed in scan (z, y, x) order, the JAX package's
    # reduction order: bit-identical means on every device
    total = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                child = v[..., :, dz, :, dy, :, dx]
                total = child if total is None else total + child
    return total / 8.0


def interp_bin(u: torch.Tensor, dim: int):
    """Index + weight for 1D linear interpolation at bin coordinate u (the
    centre of bin i sits at u = i).

      u < 0        -> index 0,      weight 1 (clamp low)
      u >= dim - 1 -> index dim-2,  weight 0 (clamp high: all on dim-1)
      else         -> index floor(u), weight 1 - frac(u)
    Returns (i, w) where value = w * v[i] + (1 - w) * v[i + 1].
    """
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, dim - 2)
    w = 1.0 - (u - i.to(u.dtype))
    w = torch.where(u < 0.0, torch.ones_like(w), w)
    w = torch.where(u >= dim - 1, torch.zeros_like(w), w)
    return i, w


def interp_coord(c: torch.Tensor, dim: int):
    """interp_bin at voxel coordinate c, 0.5-center convention (voxel i's
    centre at c = i + 0.5). c - 0.5 is exact for c in [0.5, 2^23] and
    negative below 0.5, so the clamps are the reference's c < 0.5 and
    c >= dim - 0.5."""
    return interp_bin(c - 0.5, dim)
