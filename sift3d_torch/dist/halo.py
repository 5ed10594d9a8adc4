"""Z-sharded volumes: placement, halo exchange and the sharded blur.

The port's counterpart of ``sift3d.dist.halo``. A [..., Z, Y, X] volume is
a list of shards of tz planes each along Z (the third axis from the end),
shard i on mesh[i]. A halo is `radius` planes from the Z neighbours, zeros
past the global ends; when the radius exceeds tz it is relayed from
several shards, as the JAX package's multi-hop ppermute does. The planes
move with ``.to(device)`` (a no-op between shards of one device).

The blur (K7 on the halo-extended shard, cropped) equals the whole-volume
blur bit for bit: K7 and its plain version are each one ascending
multiply-add chain over the taps in range, and a zero halo plane past the
global end adds fma(t, 0, acc) = acc.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from sift3d_torch.kernels.gauss import gaussian_filter_size
from sift3d_torch.kernels.gauss_cuda import blur3d


def shard_volume(vol: torch.Tensor, mesh: Sequence[torch.device]) -> List[torch.Tensor]:
    """Split a [..., Z, Y, X] volume into len(mesh) Z shards, shard i on
    mesh[i]; Z must divide evenly."""
    n = len(mesh)
    zd = vol.shape[-3]
    if zd % n:
        raise ValueError(f"Z = {zd} does not split into {n} shards")
    tz = zd // n
    return [vol[..., i * tz : (i + 1) * tz, :, :].to(dev).contiguous() for i, dev in enumerate(mesh)]


def planes(shards: Sequence[torch.Tensor], z0: int, z1: int, device) -> torch.Tensor:
    """Global planes [z0, z1) of a Z-sharded volume on `device`, zeros
    where outside the sharded depth."""
    tz = shards[0].shape[-3]
    total = tz * len(shards)
    lead = tuple(shards[0].shape[:-3])
    yx = tuple(shards[0].shape[-2:])
    parts = []

    def zeros(count):
        return torch.zeros(lead + (count,) + yx, dtype=shards[0].dtype, device=device)

    if z0 < 0:
        parts.append(zeros(min(z1, 0) - z0))
    for i, shard in enumerate(shards):
        lo, hi = max(z0, i * tz), min(z1, (i + 1) * tz)
        if lo < hi:
            parts.append(shard[..., lo - i * tz : hi - i * tz, :, :].to(device))
    if z1 > total:
        parts.append(zeros(z1 - max(z0, total)))
    return torch.cat(parts, dim=-3) if len(parts) > 1 else parts[0].contiguous()


def exchange_halo_z(shards: Sequence[torch.Tensor], radius: int) -> List[torch.Tensor]:
    """Each shard with `radius` planes of its Z neighbours attached on each
    side ([..., tz + 2 radius, Y, X]), zeros past the global ends."""
    tz = shards[0].shape[-3]
    return [
        planes(shards, i * tz - radius, (i + 1) * tz + radius, s.device)
        for i, s in enumerate(shards)
    ]


def blur3d_sharded(shards: Sequence[torch.Tensor], sigma: float, min_value: float = 0.01) -> List[torch.Tensor]:
    """Zero-border separable blur of a Z-sharded [Z, Y, X] volume: K7 on
    each halo-extended shard, cropped. Equal to ``blur3d`` on the gathered
    volume, bit for bit."""
    if sigma <= 0.0:
        return list(shards)
    radius = gaussian_filter_size(sigma, min_value) // 2
    tz = shards[0].shape[-3]
    return [
        blur3d(ext, sigma, min_value)[radius : radius + tz]
        for ext in exchange_halo_z(shards, radius)
    ]
