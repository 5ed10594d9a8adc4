"""Scale-space pyramid: initial blur, per-octave Gaussian stack, DoGs and
extrema mask, 2x subsample.

PyTorch port of ``sift3d.pipeline.pyramid`` (pyramid.py:66-129), the
non-TPU branch, with the fused CUDA kernel K1 (``dogs_extrema``) in place
of the subtract + stencil.

Sigma schedule (MultiScale.cpp:288-291, 365-369, 526-527):
  level 0 blur: sqrt(sigma_base^2 - sigma_init^2) applied to the input
  level j blur: sigma_{j-1} * sqrt(2^(2/3) - 1), sigma_j = 1.6 * 2^(j/3)
  next octave base: 2x subsample of level 3 (sigma = 3.2 == 2 * 1.6)
"""

from __future__ import annotations

import torch

from sift3d_torch.core.config import SiftConfig, initial_blur_sigma
from sift3d_torch.kernels.extrema_cuda import dogs_extrema
from sift3d_torch.kernels.gauss import blur3d
from sift3d_torch.kernels.resample import subsample_2x


def initial_blur_core(img: torch.Tensor, cfg: SiftConfig):
    """Raise the input image to sigma_base (MultiScale.cpp:288-298)."""
    return blur3d(img, initial_blur_sigma(cfg), cfg.blur_precision)


def octave_core(base: torch.Tensor, cfg: SiftConfig):
    """One octave of a [Z, Y, X] base: returns (gstack [6, Z, Y, X],
    dogs [5, Z, Y, X], mask [3, Z, Y, X] int8, next_base [Z/2, Y/2, X/2])."""
    inc = cfg.incremental_sigmas()
    levels = [base]
    for j in range(1, cfg.blurs_total):
        levels.append(blur3d(levels[-1], inc[j - 1], cfg.blur_precision))
    gstack = torch.stack(levels)
    dogs, mask = dogs_extrema(gstack)
    next_base = subsample_2x(levels[cfg.blurs_per_octave])
    return gstack, dogs, mask, next_base


def num_octaves(shape_zyx, cfg: SiftConfig) -> int:
    """Octaves until any dimension would be <= 2 (MultiScale.cpp:359-360)."""
    n = 0
    z, y, x = shape_zyx
    while z > 2 and y > 2 and x > 2:
        n += 1
        z, y, x = z // 2, y // 2, x // 2
    return n
