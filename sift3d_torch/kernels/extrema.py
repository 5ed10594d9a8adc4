"""Strict 3-level DoG extrema (plain form) and quadratic refinement.

The reference detects extrema as a strict extremum over the full
80-comparison neighbourhood: 26 in-level + 27 below + 27 above
(MultiScale.cpp:2140-2400 and 425-453). ``extrema_mask`` is the shifted-
compare form of ``sift3d.kernels.extrema.extrema_mask``; the fused DoG +
extrema CUDA kernel (``extrema_cuda``) is held against it.
"""

from __future__ import annotations

import itertools

import torch

from sift3d_torch.core.numerics import fma_exact


def extrema_mask(dogs: torch.Tensor) -> torch.Tensor:
    """Strict 3-level extrema over a [L, Z, Y, X] DoG stack (L >= 3).

    Returns int8 [L-2, Z, Y, X]: +1 where dogs[c+1] is a strict maximum
    over its 80-voxel neighbourhood (levels c, c+1, c+2), -1 for strict
    minima, 0 elsewhere. Borders (any spatial index at 0 or dim-1) are 0,
    matching the reference's interior-only scan (MultiScale.cpp:2210-2216).
    """
    num_levels = dogs.shape[0]
    z, y, x = dogs.shape[1:]
    centers = dogs[1 : num_levels - 1]
    pad = torch.nn.functional.pad(dogs, (1, 1, 1, 1, 1, 1))
    is_max = torch.ones(centers.shape, dtype=torch.bool, device=dogs.device)
    is_min = torch.ones(centers.shape, dtype=torch.bool, device=dogs.device)
    for dl in (-1, 0, 1):
        lvl = pad[1 + dl : 1 + dl + num_levels - 2]
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if dl == 0 and dz == 0 and dy == 0 and dx == 0:
                continue
            neigh = lvl[:, 1 + dz : 1 + dz + z, 1 + dy : 1 + dy + y, 1 + dx : 1 + dx + x]
            is_max &= centers > neigh
            is_min &= centers < neigh
    mask = is_max.to(torch.int8) - is_min.to(torch.int8)
    interior = torch.zeros((z, y, x), dtype=torch.bool, device=dogs.device)
    interior[1:-1, 1:-1, 1:-1] = True
    return torch.where(interior, mask, torch.zeros_like(mask))


def _det3(p1, p2, p3, q1, q2, q3):
    """det [[p1 p2 p3], [q1 q2 q3], [1 1 1]] as the chain of fused
    multiply-adds the compiled JAX package evaluates: its 6-term sum
    p1*q2 - p1*q3 - p2*q1 + p3*q1 + p2*q3 - p3*q2 has terms of ~x^3 that
    cancel, so the f32 result depends on where it rounds."""
    t = fma_exact(p1, q2, -(p1 * q3))
    t = fma_exact(-p2, q1, t)
    t = fma_exact(p3, q1, t)
    t = fma_exact(p2, q3, t)
    return fma_exact(-p3, q2, t)


def quadratic_interp_1d(f_lo, f_c, f_hi, x_lo, x_c, x_hi):
    """Vertex of the parabola through three points; x_c if degenerate.

    Port of interpolate_extremum_quadratic (MultiScale.cpp:1641-1697), the
    release behaviour (SURVEY.md section 2.3 quirk 6). The Cramer
    determinants cancel catastrophically in f32 (a vertex moves by ~1e-2
    voxels with the rounding pattern), so they follow the JAX package's
    compiled evaluation exactly (see _det3). The three determinants run as
    one stacked chain: elementwise, so the same bits, in a fifth of the
    operations (on the card, of the launches).
    """
    f_lo, f_c, f_hi, x_lo, x_c, x_hi = torch.broadcast_tensors(f_lo, f_c, f_hi, x_lo, x_c, x_hi)
    a1, a2, a3 = x_lo * x_lo, x_c * x_c, x_hi * x_hi
    det, detx, dety = _det3(
        torch.stack([a1, f_lo, a1]), torch.stack([a2, f_c, a2]), torch.stack([a3, f_hi, a3]),
        torch.stack([x_lo, x_lo, f_lo]), torch.stack([x_c, x_c, f_c]), torch.stack([x_hi, x_hi, f_hi]),
    )

    valid = (det != 0) & (detx != 0)
    denom = torch.where(valid, -2.0 * detx, torch.ones_like(detx))
    return torch.where(valid, dety / denom, x_c)
