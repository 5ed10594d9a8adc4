"""Scale-space pyramid: initial blur, per-octave Gaussian stack, DoGs and
extrema mask, 2x subsample.

PyTorch port of ``sift3d.pipeline.pyramid`` (pyramid.py:66-129), the
non-TPU branch, with two CUDA kernels: every blur is K7
(``gauss_cuda.blur3d``), and K1 (``dogs_extrema``) takes the place of the
subtract + stencil.

Each function takes one [Z, Y, X] volume or a [B, Z, Y, X] batch of
same-shape volumes (batched extraction's one pyramid per shape group,
``sift3d.pipeline.extract._phase1_program``): K7 blurs the batch in one
launch and K1 takes it in one launch. The CPU's plain blur runs volume by
volume: its banded matmul sums in another order when a batch changes the
matmul's shape (at 5x6x5, the deepest T1 octave, by up to 3e-8), and a
volume's pyramid must not depend on its batch.

Sigma schedule (MultiScale.cpp:288-291, 365-369, 526-527):
  sigma_init = 0.5 / initial_image_scale
  level 0 blur: sqrt(sigma_base^2 - sigma_init^2) applied to the input
  level j blur: sigma_{j-1} * sqrt(2^(2/3) - 1), sigma_j = 1.6 * 2^(j/3)
  next octave base: 2x subsample of level 3 (sigma = 3.2 == 2 * 1.6)
"""

from __future__ import annotations

import torch

from sift3d_torch.core.config import SiftConfig, initial_blur_sigma
from sift3d_torch.kernels.extrema_cuda import dogs_extrema
from sift3d_torch.kernels.gauss_cuda import blur3d
from sift3d_torch.kernels.resample import subsample_2x


def _blur(vol: torch.Tensor, sigma: float, cfg: SiftConfig) -> torch.Tensor:
    """K7 on a volume or a batch; on the CPU, volume by volume."""
    if vol.ndim == 4 and vol.device.type == "cpu":
        return torch.stack([blur3d(v, sigma, cfg.blur_precision) for v in vol])
    return blur3d(vol, sigma, cfg.blur_precision)


def initial_blur_core(img: torch.Tensor, cfg: SiftConfig, initial_image_scale: float = 1.0):
    """Raise the input image or batch to sigma_base (MultiScale.cpp:288-298)."""
    return _blur(img, initial_blur_sigma(cfg, initial_image_scale), cfg)


# the f32 volumes of its grid that one volume of a batch holds at its
# pyramid's peak, K1's launch in octave 0 of octave_core: the batch's slot
# (1), the six blur levels (6, the initial blur's output among them) and
# their torch.stack copy (6), the DoGs (5), the extrema mask's three int8
# planes (3/4) and the next octave's base (1/8). K7's scratch (1) is freed
# before it, and the feature stage's rows, which come after, take far less.
# extract.volume_bytes plans sub-batches with it.
OCTAVE0_VOLUMES = 1 + 6 + 6 + 5 + 3 / 4 + 1 / 8


def octave_core(base: torch.Tensor, cfg: SiftConfig):
    """One octave of a [Z, Y, X] base: returns (gstack [6, Z, Y, X],
    dogs [5, Z, Y, X], mask [3, Z, Y, X] int8, next_base [Z/2, Y/2, X/2]);
    of a [B, Z, Y, X] batch of bases, the same with a leading B."""
    inc = cfg.incremental_sigmas()
    levels = [base]
    for j in range(1, cfg.blurs_total):
        levels.append(_blur(levels[-1], inc[j - 1], cfg))
    gstack = torch.stack(levels, dim=base.ndim - 3)
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
