"""K7: separable 3D Gaussian blur (CUDA kernels + plain form).

Replaces the Pallas kernel ``sift3d.kernels.gauss_pallas.blur3d_pallas``;
the CUDA source is ``csrc/blur3d.cu``. :func:`blur3d` runs the plain
PyTorch version (``gauss.blur3d``, banded matmuls) for a CPU tensor and the
kernel for a CUDA tensor; every blur of the port (pyramid levels, the BRIEF
pre-blur of 11^3 patches, the histogram blur, the debug slices) goes
through it. The kernel is the ascending fused multiply-add chain per axis
pass. The plain version computes that chain on the CPU, so the card's blur
equals the CPU's bit for bit, except where y and x are both small (the
5x6x5 deepest octave of a 182x218x182 volume): there PyTorch's CPU matmul
sums the y pass in another order, a few ulps of the terms' magnitude
away from the chain.

:func:`blur_launch_geometry` picks the kernels' launch for a shape:
batches of small volumes whole in shared memory, several to a block;
others as an xy pass on plane tiles and a z pass on columns, each with
enough blocks to give every SM at least two where the volume allows it.
"""

from __future__ import annotations

import functools

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.gauss import blur3d as blur3d_plain
from sift3d_torch.kernels.gauss import gaussian_kernel_1d

MAX_RADIUS = 8  # csrc/blur3d.cu MAX_R
TILE_X = 32  # csrc/blur3d.cu TX: xy tile columns
THREAD_ROWS = 8  # csrc/blur3d.cu ROWS: an xy tile has 8 * ry rows
SMALL_Z = 16  # csrc/blur3d.cu SMALL_Z
SMALL_COLS = 256  # csrc/blur3d.cu SMALL_COLS: (y, x) columns of a small block
# the z pass's (outputs a thread, block x, block y), most preferred first
Z_SHAPES = ((16, 32, 2), (16, 32, 1), (4, 32, 2), (4, 32, 1))
KIND_IDS = {"small": 0, "xy_z": 1}
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def host_taps(sigma: float, min_value: float) -> torch.Tensor:
    """The 1D taps of a sigma blur as an f32 CPU tensor (the kernel takes
    them by value)."""
    return torch.from_numpy(gaussian_kernel_1d(sigma, min_value).copy())


@functools.lru_cache(maxsize=None)
def device_taps(sigma: float, min_value: float, device: torch.device) -> torch.Tensor:
    """The 1D taps of a sigma blur as an f32 tensor on `device`."""
    return host_taps(sigma, min_value).to(device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def blur_launch_geometry(shape, r: int, n_sm: int = H100_SMS) -> dict:
    """The launch of csrc/blur3d.cu for a [B, Z, Y, X] batch at radius r on
    a card with n_sm SMs: a dict with ``kind`` and the numbers it passes.

    Batches of at least n_sm small volumes (Z <= 16, Y * X <= 256) go
    whole into shared memory, ``vpb`` to a block (as many as fit while there
    are still >= 2 * n_sm blocks): one block walks its volumes' passes one
    after another, which only pays when the blocks fill the card. Others
    take two launches ("xy_z"): the xy pass on tiles of
    32 x 8 * ``ry`` of each plane, the z pass with ``z`` = (outputs a
    thread, block x, block y); each the largest that still gives >= 2 * n_sm
    blocks where the shape allows it.
    """
    b, z, y, x = (int(s) for s in shape)
    target = 2 * n_sm
    if z <= SMALL_Z and y * x <= SMALL_COLS and b >= n_sm:
        vpb = SMALL_COLS // (y * x)
        while vpb > 1 and _cdiv(b, vpb) < target:
            vpb -= 1
        return dict(kind="small", vpb=vpb)
    planes, x_tiles = b * z, _cdiv(x, TILE_X)
    ry = next((n for n in (8, 4, 2) if planes * x_tiles * _cdiv(y, THREAD_ROWS * n) >= target), 1)
    for z_shape in Z_SHAPES:
        seg, bx, by = z_shape
        if b * _cdiv(y * x, bx) * _cdiv(_cdiv(z, seg), by) >= target:
            break
    return dict(kind="xy_z", ry=ry, z=z_shape)


@functools.lru_cache(maxsize=None)
def _geometry_ints(kind: str, vpb: int, ry: int, z_shape: tuple) -> torch.Tensor:
    """csrc/blur3d.cu's geom array (host memory)."""
    return torch.tensor([KIND_IDS[kind], vpb, ry, *z_shape], dtype=torch.int32)


def blur3d(vol: torch.Tensor, sigma: float, min_value: float = 0.01):
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
    taps = host_taps(float(sigma), float(min_value))
    r = taps.shape[0] // 2
    if r == 0:
        return vol
    if r > MAX_RADIUS:
        raise ValueError(f"blur radius {r} (sigma {sigma}) exceeds the kernel's {MAX_RADIUS}")
    if vol.numel() == 0:
        return torch.empty_like(vol)
    shape = (1, *vol.shape) if vol.ndim == 3 else tuple(vol.shape)
    return _launch(vol, taps, blur_launch_geometry(shape, r, sm_count(vol.device)))


def _launch(vol: torch.Tensor, taps: torch.Tensor, geom: dict) -> torch.Tensor:
    """csrc/blur3d.cu on a non-empty contiguous f32 CUDA volume or batch
    with 3..17 host taps, at the launch geom (``blur_launch_geometry``'s
    form)."""
    shape = (1, *vol.shape) if vol.ndim == 3 else tuple(vol.shape)
    out = torch.empty_like(vol)
    tmp = torch.empty_like(vol) if geom["kind"] == "xy_z" else out
    ints = _geometry_ints(
        geom["kind"], geom.get("vpb", 0), geom.get("ry", 0), tuple(geom.get("z", (0, 0, 0)))
    )
    r = taps.shape[0] // 2
    cuda_lib.launch("sift3d_blur3d", vol, out, tmp, taps, ints, r, *shape, device=vol.device)
    return out
