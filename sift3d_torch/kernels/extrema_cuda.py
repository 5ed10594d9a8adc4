"""K1 and K6: strict 80-neighbour extrema masks (CUDA kernels + plain forms).

K1 :func:`dogs_extrema` replaces the Pallas kernel ``sift3d.kernels.
extrema_pallas.dogs_extrema_pallas``: DoGs of a Gaussian stack, or of a
batch of them (batched extraction's stacked pyramid), and their mask,
fused. K6 :func:`extrema_mask` replaces ``extrema_mask_pallas``: the
mask of precomputed DoGs, which is what the Z-sharded path runs on each
shard's one-plane-halo DoG slab. Both are entries of ``csrc/
dogs_extrema.cu``. Each runs the plain PyTorch version for a CPU tensor
and the kernel for a CUDA tensor; the two are bit-identical, since the
subtraction is exact and the kernel takes the 80-neighbour max and min
exactly (NaN-propagating) where the plain version compares one by one.

The kernel tests a voxel against the max and min of its 80 neighbours,
built by separation (the 3-column max/min of a row, then the 3 x 3 square
and the 8-ring around the centre, then over planes and levels), with a
block of (ty + 2) x 32 threads walking a run of zr planes. On an H100 K1 is
bound by device memory (47 B a voxel) and K6, with half its bytes (23 B),
by its instructions. :func:`extrema_launch_geometry` picks ty and zr per
shape and kernel: K1 many short z runs, K6 long ones (the least halo), each
with at least 2 x 132 blocks where the shape allows; the deep octaves the
launch with the most blocks.
"""

from __future__ import annotations

import functools

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels import extrema as plain
from sift3d_torch.kernels.gauss_cuda import H100_SMS, sm_count

LANES = 32  # csrc/dogs_extrema.cu LANES: x columns a warp loads
TILE_X = LANES - 2  # csrc/dogs_extrema.cu TX: x columns a warp emits
# (ty, zr) in order of preference, from chip_smoke.py phase 2's sweeps on an
# H100: K1, bound by device memory, runs fastest with many short z runs; K6,
# bound by its instructions, with the least halo
PREFERRED = {
    "dogs_extrema": ((16, 4), (8, 8), (8, 4), (4, 4), (4, 2)),
    "extrema_mask": ((8, 64), (8, 32), (8, 16), (8, 8), (4, 8), (4, 4), (4, 2)),
}
# every launch extrema_launch_geometry can choose: the preferred ones, and
# one plane a block for the deepest octaves
LAUNCHES = tuple(sorted({g for gs in PREFERRED.values() for g in gs} | {(4, 1)}, reverse=True))


def tiles(d: int, t: int) -> int:
    """Tiles of t emitted positions over the d - 2 inside ones, at least one
    (csrc/dogs_extrema.cu ``tiles``)."""
    return -(-(d - 2) // t) if d > 2 else 1


def launch_blocks(shape, ty: int, zr: int) -> int:
    """Blocks of a launch for (B, Z, Y, X)."""
    b, z, y, x = shape
    return b * tiles(x, TILE_X) * tiles(y, ty) * tiles(z, zr)


@functools.lru_cache(maxsize=None)
def extrema_launch_geometry(shape, kernel: str, n_sm: int = H100_SMS) -> dict:
    """The launch of csrc/dogs_extrema.cu's `kernel` ("dogs_extrema" or
    "extrema_mask") for [B, 5 or 6, Z, Y, X] inputs given as (B, Z, Y, X) on
    a card with n_sm SMs: ``ty`` (rows a block emits) and ``zr`` (planes).
    The kernel's first preferred launch with >= 2 * n_sm blocks; where none
    has that many (the deep octaves), the launch with the most blocks, whose
    serial plane walk is the shortest."""
    shape = tuple(int(s) for s in shape)
    for ty, zr in PREFERRED[kernel]:
        if launch_blocks(shape, ty, zr) >= 2 * n_sm:
            return dict(ty=ty, zr=zr)
    ty, zr = max(LAUNCHES, key=lambda g: (launch_blocks(shape, *g), -g[0], -g[1]))
    return dict(ty=ty, zr=zr)


def dogs_extrema_plain(gstack: torch.Tensor):
    """[6, Z, Y, X] Gaussian stack -> (dogs [5, Z, Y, X] f32, mask
    [3, Z, Y, X] int8); a [B, 6, Z, Y, X] batch -> [B, 5, ...] and
    [B, 3, ...] (the mask by a loop over the volumes)."""
    dogs = gstack[..., :-1, :, :, :] - gstack[..., 1:, :, :, :]
    return dogs, extrema_mask_plain(dogs)


def dogs_extrema(gstack: torch.Tensor):
    """DoGs + extrema mask of one octave's [6, Z, Y, X] Gaussian stack, or
    of a [B, 6, Z, Y, X] batch in one launch (see dogs_extrema_plain)."""
    if cuda_lib.route(gstack) == "plain":
        return dogs_extrema_plain(gstack)
    if gstack.ndim not in (4, 5):
        raise ValueError(f"expected [6, Z, Y, X] or [B, 6, Z, Y, X], got {tuple(gstack.shape)}")
    cuda_lib.require_cuda(gstack, "gstack", torch.float32, gstack.ndim)
    batch = gstack if gstack.ndim == 5 else gstack[None]
    b, nl, z, y, x = batch.shape
    if nl != 6:
        raise ValueError(f"gstack must hold 6 levels, got {tuple(gstack.shape)}")
    geom = extrema_launch_geometry((b, z, y, x), "dogs_extrema", sm_count(gstack.device))
    dogs, mask = _launch_dogs(batch, geom)
    return (dogs, mask) if gstack.ndim == 5 else (dogs[0], mask[0])


def _launch_dogs(batch: torch.Tensor, geom: dict):
    """K1 on a contiguous f32 [B, 6, Z, Y, X] CUDA batch at launch geom
    (``extrema_launch_geometry``'s form)."""
    b, _, z, y, x = batch.shape
    dogs = torch.empty((b, 5, z, y, x), dtype=torch.float32, device=batch.device)
    mask = torch.empty((b, 3, z, y, x), dtype=torch.int8, device=batch.device)
    if mask.numel():
        cuda_lib.launch("sift3d_dogs_extrema", batch, dogs, mask, b, z, y, x, geom["ty"], geom["zr"],
                        device=batch.device)
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
    geom = extrema_launch_geometry((b, z, y, x), "extrema_mask", sm_count(dogs.device))
    mask = _launch_mask(batch, geom)
    return mask if dogs.ndim == 5 else mask[0]


def _launch_mask(batch: torch.Tensor, geom: dict) -> torch.Tensor:
    """K6 on a contiguous f32 [B, 5, Z, Y, X] CUDA batch at launch geom."""
    b, _, z, y, x = batch.shape
    mask = torch.empty((b, 3, z, y, x), dtype=torch.int8, device=batch.device)
    if mask.numel():
        cuda_lib.launch("sift3d_extrema_mask", batch, mask, b, z, y, x, geom["ty"], geom["zr"],
                        device=batch.device)
    return mask
