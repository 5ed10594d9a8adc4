"""K2 and K4: 11^3 patch samplers (CUDA kernels + plain forms).

K2 :func:`sample_identity` replaces the Pallas kernel ``sift3d.kernels.
patch.sample_patches_identity_slab`` (``csrc/sample_identity.cu``); K4
:func:`sample_rotated` replaces ``sample_patches_rotated_slab`` and, for
the large-scale tail, ``sample_patches_rotated_pallas`` (K5) in one kernel
(``csrc/sample_rotated.cu``).

Both read the full level volume with the _interp_coord rule (no boxes),
so they carry no scale bound. Each public function runs the plain PyTorch
version for CPU tensors and the kernel for CUDA tensors. The plain
versions compute in the kernels' operation order (contract z, then y,
then x), so the two agree to the bit on one device.
"""

from __future__ import annotations

import torch

from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.patch import PATCH_DIM, PATCH_RAD, invert_3x3, patch_grid
from sift3d_torch.kernels.resample import interp_coord


def _trilinear_zyx(gflat, base, wz, wy, wx, stride_z: int, stride_y: int):
    """8-corner trilinear value at flat corner index `base`, contracting z
    first, then y, then x (weights w apply to the lower corner)."""

    def c(dz, dy, dx):
        return gflat[base + (dz * stride_z + dy * stride_y + dx)]

    a00 = wz * c(0, 0, 0) + (1.0 - wz) * c(1, 0, 0)
    a01 = wz * c(0, 0, 1) + (1.0 - wz) * c(1, 0, 1)
    a10 = wz * c(0, 1, 0) + (1.0 - wz) * c(1, 1, 0)
    a11 = wz * c(0, 1, 1) + (1.0 - wz) * c(1, 1, 1)
    b0 = wy * a00 + (1.0 - wy) * a10
    b1 = wy * a01 + (1.0 - wy) * a11
    return wx * b0 + (1.0 - wx) * b1


def _step(scales: torch.Tensor) -> torch.Tensor:
    """Sample spacing 2 * scale / 5 (the patch radius covers 2x the scale).
    The divisor is a tensor: PyTorch on CUDA multiplies by the reciprocal
    of a scalar divisor, which is not the correctly rounded quotient the
    kernels and the JAX package compute."""
    return 2.0 * scales / torch.full_like(scales, float(PATCH_RAD))


def sample_identity_plain(gstack, lvl, centers, scales) -> torch.Tensor:
    """gstack [L, Z, Y, X] f32, lvl [R] int, centers [R, 3] (x, y, z),
    scales [R] -> axis-aligned patches [R, 11, 11, 11] (z, y, x)."""
    _, zd, yd, xd = gstack.shape
    fac = _step(scales)
    offs = torch.arange(-PATCH_RAD, PATCH_RAD + 1, dtype=torch.float32, device=gstack.device)
    u = centers[:, :, None] + offs[None, None, :] * fac[:, None, None]  # [R, 3, 11]
    ix, wx = interp_coord(u[:, 0], xd)
    iy, wy = interp_coord(u[:, 1], yd)
    iz, wz = interp_coord(u[:, 2], zd)
    base = (
        lvl.to(torch.int64)[:, None, None, None] * (zd * yd * xd)
        + iz[:, :, None, None] * (yd * xd)
        + iy[:, None, :, None] * xd
        + ix[:, None, None, :]
    )
    return _trilinear_zyx(
        gstack.reshape(-1), base, wz[:, :, None, None], wy[:, None, :, None],
        wx[:, None, None, :], yd * xd, xd,
    )


def sample_rotated_plain(gstack, lvl, centers, scales, oris) -> torch.Tensor:
    """Rotated patches [R, 11, 11, 11]: grid point k maps to
    centre + ori^-1 k * (2 * scale / 5); trilinear with the _interp_coord
    saturation; points with x outside [0, X) read 0."""
    _, zd, yd, xd = gstack.shape
    r = centers.shape[0]
    grid = torch.from_numpy(patch_grid()).to(gstack.device)  # [V, (x, y, z)]
    gx, gy, gz = grid[:, 0], grid[:, 1], grid[:, 2]
    inv = invert_3x3(oris)
    fac = _step(scales)[:, None]

    def axis(i):
        rot = inv[:, i, 0, None] * gx + inv[:, i, 1, None] * gy + inv[:, i, 2, None] * gz
        return rot * fac + centers[:, i, None]  # [R, V]

    x, y, z = axis(0), axis(1), axis(2)
    ix, wx = interp_coord(x, xd)
    iy, wy = interp_coord(y, yd)
    iz, wz = interp_coord(z, zd)
    base = lvl.to(torch.int64)[:, None] * (zd * yd * xd) + iz * (yd * xd) + iy * xd + ix
    vals = _trilinear_zyx(gstack.reshape(-1), base, wz, wy, wx, yd * xd, xd)
    vals = torch.where((x < 0) | (x >= xd), torch.zeros_like(vals), vals)
    return vals.reshape(r, PATCH_DIM, PATCH_DIM, PATCH_DIM)


def _check_rows(gstack, lvl, centers, scales):
    cuda_lib.require_cuda(gstack, "gstack", torch.float32, 4)
    cuda_lib.require_cuda(lvl, "lvl", torch.int32, 1)
    cuda_lib.require_cuda(centers, "centers", torch.float32, 2)
    cuda_lib.require_cuda(scales, "scales", torch.float32, 1)
    r = lvl.shape[0]
    if centers.shape != (r, 3) or scales.shape != (r,):
        raise ValueError(
            f"row shapes disagree: lvl {tuple(lvl.shape)}, centers "
            f"{tuple(centers.shape)}, scales {tuple(scales.shape)}"
        )
    for t in (lvl, centers, scales):
        if t.device != gstack.device:
            raise ValueError(f"all tensors must be on {gstack.device}, got {t.device}")
    return r


def sample_identity(gstack, lvl, centers, scales) -> torch.Tensor:
    """K2: identity-orientation 11^3 patches (see sample_identity_plain).
    Rows whose level is outside [0, L) come back as NaN from the kernel."""
    if cuda_lib.route(gstack) == "plain":
        return sample_identity_plain(gstack, lvl, centers, scales)
    r = _check_rows(gstack, lvl, centers, scales)
    nl, zd, yd, xd = gstack.shape
    out = torch.empty((r, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=gstack.device)
    if r == 0:
        return out
    cuda_lib.launch(
        "sift3d_sample_identity", gstack, lvl, centers, scales, out, r, nl, zd, yd, xd,
        device=gstack.device,
    )
    sample_identity.launches += 1
    return out


def sample_rotated(gstack, lvl, centers, scales, oris) -> torch.Tensor:
    """K4: rotated 11^3 patches (see sample_rotated_plain)."""
    if cuda_lib.route(gstack) == "plain":
        return sample_rotated_plain(gstack, lvl, centers, scales, oris)
    r = _check_rows(gstack, lvl, centers, scales)
    cuda_lib.require_cuda(oris, "oris", torch.float32, 3)
    if oris.shape != (r, 3, 3) or oris.device != gstack.device:
        raise ValueError(f"oris must be [{r}, 3, 3] on {gstack.device}, got {tuple(oris.shape)}")
    nl, zd, yd, xd = gstack.shape
    out = torch.empty((r, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=gstack.device)
    if r == 0:
        return out
    cuda_lib.launch(
        "sift3d_sample_rotated", gstack, lvl, centers, scales, oris, out, r, nl, zd, yd, xd,
        device=gstack.device,
    )
    sample_rotated.launches += 1
    return out


sample_identity.launches = 0
sample_rotated.launches = 0
