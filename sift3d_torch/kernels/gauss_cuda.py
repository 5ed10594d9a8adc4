"""K7: fused separable 3D Gaussian blur (CUDA kernel + plain form).

Replaces the Pallas kernel ``sift3d.kernels.gauss_pallas.blur3d_pallas``;
the CUDA source is ``csrc/blur3d.cu``. :func:`blur3d` runs the plain
PyTorch version (``gauss.blur3d``, banded matmuls) for a CPU tensor and the
kernel for a CUDA tensor; every blur of the port (pyramid levels, the BRIEF
pre-blur of 11^3 patches, the debug slices) goes through it. The kernel is
the ascending fused multiply-add chain that the plain version computes on
the CPU, so the card's blur equals the CPU's bit for bit.
"""

from __future__ import annotations

import functools

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.gauss import blur3d as blur3d_plain
from sift3d_torch.kernels.gauss import gaussian_kernel_1d

MAX_RADIUS = 8  # csrc/blur3d.cu MAX_R


@functools.lru_cache(maxsize=None)
def device_taps(sigma: float, min_value: float, device: torch.device) -> torch.Tensor:
    """The 1D taps of a sigma blur as an f32 tensor on `device`."""
    return torch.from_numpy(gaussian_kernel_1d(sigma, min_value).copy()).to(device)


def blur3d(vol: torch.Tensor, sigma: float, min_value: float = 0.01) -> torch.Tensor:
    """Zero-border separable blur of a [Z, Y, X] volume or a [B, Z, Y, X]
    batch, x pass, then y, then z (see ``gauss.blur3d``). sigma <= 0
    returns the input."""
    if cuda_lib.route(vol) == "plain":
        return blur3d_plain(vol, sigma, min_value)
    if sigma <= 0.0:
        return vol
    if vol.ndim not in (3, 4):
        raise ValueError(f"expected [Z, Y, X] or [B, Z, Y, X], got shape {tuple(vol.shape)}")
    cuda_lib.require_cuda(vol, "vol", torch.float32, vol.ndim)
    taps = device_taps(float(sigma), float(min_value), vol.device)
    r = taps.shape[0] // 2
    if r == 0:
        return vol
    if r > MAX_RADIUS:
        raise ValueError(f"blur radius {r} (sigma {sigma}) exceeds the kernel's {MAX_RADIUS}")
    b, z, y, x = (1, *vol.shape) if vol.ndim == 3 else vol.shape
    out = torch.empty_like(vol)
    if out.numel() == 0:
        return out
    cuda_lib.launch("sift3d_blur3d", vol, out, taps, r, b, z, y, x, device=vol.device)
    blur3d.launches += 1
    return out


blur3d.launches = 0
