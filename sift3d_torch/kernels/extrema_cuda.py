"""K1 and K6: strict 80-neighbour extrema masks (CUDA kernels + plain forms).

K1 :func:`dogs_extrema` replaces the Pallas kernel ``sift3d.kernels.
extrema_pallas.dogs_extrema_pallas``: DoGs of a Gaussian stack and their
mask, fused. K6 :func:`extrema_mask` replaces ``extrema_mask_pallas``: the
mask of precomputed DoGs, which is what the Z-sharded path runs on each
shard's one-plane-halo DoG slab. Both are entries of ``csrc/
dogs_extrema.cu``. Each runs the plain PyTorch version for a CPU tensor
and the kernel for a CUDA tensor; the two are bit-identical, since the
subtraction is exact and every comparison strict.
"""

from __future__ import annotations

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels import extrema as plain


def dogs_extrema_plain(gstack: torch.Tensor):
    """[6, Z, Y, X] Gaussian stack -> (dogs [5, Z, Y, X] f32, mask
    [3, Z, Y, X] int8)."""
    dogs = gstack[:-1] - gstack[1:]
    return dogs, plain.extrema_mask(dogs)


def dogs_extrema(gstack: torch.Tensor):
    """DoGs + extrema mask of one octave's [6, Z, Y, X] Gaussian stack."""
    if cuda_lib.route(gstack) == "plain":
        return dogs_extrema_plain(gstack)
    cuda_lib.require_cuda(gstack, "gstack", torch.float32, 4)
    if gstack.shape[0] != 6:
        raise ValueError(f"gstack must hold 6 levels, got {tuple(gstack.shape)}")
    _, z, y, x = gstack.shape
    dogs = torch.empty((5, z, y, x), dtype=torch.float32, device=gstack.device)
    mask = torch.empty((3, z, y, x), dtype=torch.int8, device=gstack.device)
    cuda_lib.launch("sift3d_dogs_extrema", gstack, dogs, mask, z, y, x, device=gstack.device)
    dogs_extrema.launches += 1
    return dogs, mask


def extrema_mask_plain(dogs: torch.Tensor) -> torch.Tensor:
    """[5, Z, Y, X] or [B, 5, Z, Y, X] DoGs -> [3, Z, Y, X] / [B, 3, Z, Y,
    X] int8 (``extrema.extrema_mask``, a batch by a loop)."""
    if dogs.ndim == 5:
        return torch.stack([plain.extrema_mask(d) for d in dogs])
    return plain.extrema_mask(dogs)


def extrema_mask(dogs: torch.Tensor) -> torch.Tensor:
    """K6: the extrema mask of 5 precomputed DoG levels, one volume or a
    batch (see extrema_mask_plain)."""
    if cuda_lib.route(dogs) == "plain":
        return extrema_mask_plain(dogs)
    if dogs.ndim not in (4, 5):
        raise ValueError(f"expected [5, Z, Y, X] or [B, 5, Z, Y, X] DoGs, got {tuple(dogs.shape)}")
    cuda_lib.require_cuda(dogs, "dogs", torch.float32, dogs.ndim)
    batch = dogs if dogs.ndim == 5 else dogs[None]
    b, nl, z, y, x = batch.shape
    if nl != 5:
        raise ValueError(f"dogs must hold 5 levels, got {tuple(dogs.shape)}")
    mask = torch.empty((b, 3, z, y, x), dtype=torch.int8, device=dogs.device)
    if mask.numel() == 0:
        return mask if dogs.ndim == 5 else mask[0]
    cuda_lib.launch("sift3d_extrema_mask", batch, mask, b, z, y, x, device=dogs.device)
    extrema_mask.launches += 1
    return mask if dogs.ndim == 5 else mask[0]


dogs_extrema.launches = 0
extrema_mask.launches = 0
