"""K1: fused DoG + strict 80-neighbour extrema (CUDA kernel + plain form).

Replaces the Pallas kernel ``sift3d.kernels.extrema_pallas.
dogs_extrema_pallas``; the CUDA source is ``csrc/dogs_extrema.cu``.
:func:`dogs_extrema` runs the plain PyTorch version for a CPU tensor and
the kernel for a CUDA tensor. The two are bit-identical: the subtraction
is exact and every comparison strict.
"""

from __future__ import annotations

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.extrema import extrema_mask


def dogs_extrema_plain(gstack: torch.Tensor):
    """[6, Z, Y, X] Gaussian stack -> (dogs [5, Z, Y, X] f32, mask
    [3, Z, Y, X] int8)."""
    dogs = gstack[:-1] - gstack[1:]
    return dogs, extrema_mask(dogs)


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


dogs_extrema.launches = 0
