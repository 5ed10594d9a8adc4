"""The 11^3 patch samplers (K2's and K4's plain forms, K4's CUDA kernel)
and the fused K4.

K2's identity sampler, :func:`sample_identity_plain`, is the plain form of
the Pallas kernel ``sift3d.kernels.patch.sample_patches_identity_slab``; on
the card it runs inside the fused K2 (``features.gather_eig``,
``csrc/identity_eig.cu``). K4 :func:`sample_rotated` replaces
``sample_patches_rotated_slab`` and, for the large-scale tail,
``sample_patches_rotated_pallas`` (K5) in one kernel
(``csrc/sample_rotated.cu``; an entry point, on no path since the BRIEF
path is fused too). The fused K4, :func:`rotated_goh` (and :func:`goh` on
given patches), samples a rotated patch and computes its GoH-64 rank
descriptor in one block (``csrc/rotated_goh.cu``); the GoH path runs it.
:func:`rotated_brief` (and :func:`brief`) does the same for the BRIEF
family, pre-blur included (``csrc/rotated_brief.cu``); the BRIEF path
(``-b``, ``-br``, ``-bn``) runs it.

Both samplers read the full level volume with the _interp_coord rule (no boxes),
so they carry no scale bound. The volume may be a Z slab of a deeper one
(the Z-sharded path): ``z0`` is the global index of its first plane and
``depth`` the global Z. Sample coordinates stay global, so they clamp and
interpolate exactly as on the whole volume; only the integer plane index
is moved into the slab, and clamped to it. (The JAX package shifts the f32
coordinates by the slab origin instead, which moves samples by rounding.) Each public function runs the plain PyTorch
version for CPU tensors and the kernel for CUDA tensors. The plain
versions compute in the kernels' operation order (contract z, then y,
then x), so the two agree to the bit on one device.
"""

from __future__ import annotations

import torch

from sift3d_torch.kernels import cuda_lib, descriptor, gauss_cuda
from sift3d_torch.kernels.patch import PATCH_DIM, PATCH_RAD, invert_3x3, normalize_patches, patch_grid
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


def _slab_plane(z, z0: int, depth, zd: int):
    """Global coordinates -> (plane index in a slab of zd planes starting at
    global plane z0, weight), by the _interp_coord rule at global depth."""
    iz, wz = interp_coord(z, zd if depth is None else depth)
    return torch.clamp(iz - z0, 0, zd - 2), wz


def sample_identity_plain(gstack, lvl, centers, scales, z0: int = 0, depth=None) -> torch.Tensor:
    """gstack [L, Z, Y, X] f32 (a slab from global plane z0 of a volume
    depth deep; depth None: the whole volume), lvl [R] int, centers [R, 3]
    (x, y, z), scales [R] -> axis-aligned patches [R, 11, 11, 11] (z, y,
    x)."""
    _, zd, yd, xd = gstack.shape
    fac = _step(scales)
    offs = torch.arange(-PATCH_RAD, PATCH_RAD + 1, dtype=torch.float32, device=gstack.device)
    u = centers[:, :, None] + offs[None, None, :] * fac[:, None, None]  # [R, 3, 11]
    ix, wx = interp_coord(u[:, 0], xd)
    iy, wy = interp_coord(u[:, 1], yd)
    iz, wz = _slab_plane(u[:, 2], z0, depth, zd)
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


def sample_rotated_plain(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None) -> torch.Tensor:
    """Rotated patches [R, 11, 11, 11]: grid point k maps to
    centre + ori^-1 k * (2 * scale / 5); trilinear with the _interp_coord
    saturation; points with x outside [0, X) read 0. z0, depth as in
    sample_identity_plain."""
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
    iz, wz = _slab_plane(z, z0, depth, zd)
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


def _slab_args(gstack, z0: int, depth):
    zd = gstack.shape[1]
    depth = zd if depth is None else int(depth)
    if zd < 2 or not 0 <= z0 <= depth - zd:
        raise ValueError(f"a slab of {zd} planes from plane {z0} does not fit a depth of {depth}")
    return int(z0), depth


def sample_rotated(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None) -> torch.Tensor:
    """K4: rotated 11^3 patches (see sample_rotated_plain)."""
    if cuda_lib.route(gstack) == "plain":
        return sample_rotated_plain(gstack, lvl, centers, scales, oris, z0, depth)
    r = _check_rows(gstack, lvl, centers, scales)
    z0, depth = _slab_args(gstack, z0, depth)
    cuda_lib.require_cuda(oris, "oris", torch.float32, 3)
    if oris.shape != (r, 3, 3) or oris.device != gstack.device:
        raise ValueError(f"oris must be [{r}, 3, 3] on {gstack.device}, got {tuple(oris.shape)}")
    nl, zd, yd, xd = gstack.shape
    out = torch.empty((r, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=gstack.device)
    if r == 0:
        return out
    cuda_lib.launch(
        "sift3d_sample_rotated", gstack, lvl, centers, scales, oris, out, r, nl, zd, yd, xd, z0,
        depth, device=gstack.device,
    )
    return out


def goh_plain(patches) -> torch.Tensor:
    """GoH-64 rank descriptors of raw patches [R, 11, 11, 11]: normalize,
    gradient orientation histogram, positive normalization, rank; uint8
    [R, 64] (featExtract.cpp:477-499). The plain version of :func:`goh`."""
    d = descriptor.normalize_positive(descriptor.goh_descriptor(normalize_patches(patches)))
    return descriptor.rank_normalize(d).to(torch.uint8)


def rotated_goh_plain(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None) -> torch.Tensor:
    """GoH-64 rank descriptors of the rotated patches of
    :func:`sample_rotated_plain`; uint8 [R, 64]."""
    return goh_plain(sample_rotated_plain(gstack, lvl, centers, scales, oris, z0, depth))


def _desc_out(r: int, device, out=None) -> torch.Tensor:
    """The uint8 [r, 64] descriptor rows a wrapper writes: `out` (checked)
    when the caller gives one, so that a stage's rows land in one tensor
    without a copy, else a new tensor."""
    if out is None:
        return torch.empty((r, 64), dtype=torch.uint8, device=device)
    if out.dtype != torch.uint8 or tuple(out.shape) != (r, 64) or out.device != device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 [{r}, 64] tensor on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def _plain_into(out, rows: torch.Tensor) -> torch.Tensor:
    """A plain version's rows, copied into `out` when the caller gives one."""
    return rows if out is None else _desc_out(rows.shape[0], rows.device, out).copy_(rows)


def goh(patches, out=None) -> torch.Tensor:
    """Fused K4 on already-sampled patches [R, 11, 11, 11] (the unoriented
    rows): :func:`goh_plain` in one launch, one block per row
    (``csrc/rotated_goh.cu``), into `out` (uint8 [R, 64]) when given."""
    if cuda_lib.route(patches) == "plain":
        return _plain_into(out, goh_plain(patches))
    cuda_lib.require_cuda(patches, "patches", torch.float32, 4)
    if tuple(patches.shape[1:]) != (PATCH_DIM,) * 3:
        raise ValueError(f"patches must be [R, 11, 11, 11], got {tuple(patches.shape)}")
    out = _desc_out(patches.shape[0], patches.device, out)
    if patches.shape[0]:
        cuda_lib.launch("sift3d_goh", patches, out, patches.shape[0], device=patches.device)
    return out


def rotated_goh(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None, out=None) -> torch.Tensor:
    """Fused K4: rotated 11^3 patches (K4's sampler) and their GoH-64 rank
    descriptors in one launch, one block per row; the patch stays in the
    block's shared memory. Arguments as :func:`sample_rotated`; returns
    uint8 [R, 64] as :func:`rotated_goh_plain`, which runs for CPU tensors,
    in `out` when given."""
    if cuda_lib.route(gstack) == "plain":
        return _plain_into(out, rotated_goh_plain(gstack, lvl, centers, scales, oris, z0, depth))
    r = _check_rows(gstack, lvl, centers, scales)
    z0, depth = _slab_args(gstack, z0, depth)
    cuda_lib.require_cuda(oris, "oris", torch.float32, 3)
    if oris.shape != (r, 3, 3) or oris.device != gstack.device:
        raise ValueError(f"oris must be [{r}, 3, 3] on {gstack.device}, got {tuple(oris.shape)}")
    nl, zd, yd, xd = gstack.shape
    out = _desc_out(r, gstack.device, out)
    if r:
        cuda_lib.launch(
            "sift3d_rotated_goh", gstack, lvl, centers, scales, oris, out, r, nl, zd, yd, xd, z0,
            depth, device=gstack.device,
        )
    return out


def brief_plain(patches, variant: str, method: int = 2, blur_sigma: float = 0.95) -> torch.Tensor:
    """BRIEF, RRIEF or NRRIEF rank descriptors of raw patches [R, 11, 11,
    11]: normalize, the pre-blur, the pair differences, the variant, rank;
    uint8 [R, 64] (featExtract.cpp:477-499). The plain version of
    :func:`brief`."""
    d = descriptor.brief_descriptor(normalize_patches(patches), variant, method, blur_sigma)
    return descriptor.rank_normalize(d).to(torch.uint8)


def rotated_brief_plain(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None, variant: str = "brief",
                        method: int = 2, blur_sigma: float = 0.95) -> torch.Tensor:
    """The BRIEF-family rank descriptors of the rotated patches of
    :func:`sample_rotated_plain`; uint8 [R, 64]."""
    return brief_plain(sample_rotated_plain(gstack, lvl, centers, scales, oris, z0, depth), variant, method,
                       blur_sigma)


def _brief_args(variant: str, method: int, blur_sigma: float, device):
    """The fused BRIEF kernel's table, divisors, host taps, radius and
    variant code."""
    if variant not in descriptor.BRIEF_VARIANTS:
        raise ValueError(f"unknown BRIEF variant: {variant}")
    taps = gauss_cuda.host_taps(float(blur_sigma), 0.01)
    r = taps.shape[0] // 2
    if not 1 <= r <= gauss_cuda.MAX_RADIUS:
        raise ValueError(f"the fused BRIEF kernel takes blur radii 1..{gauss_cuda.MAX_RADIUS}, got {r} "
                         f"(sigma {blur_sigma})")
    flat, dist = descriptor.brief_pairs(method, device)
    return flat, dist, taps, r, descriptor.BRIEF_VARIANTS.index(variant)


def brief(patches, variant: str, method: int = 2, blur_sigma: float = 0.95, out=None) -> torch.Tensor:
    """The fused BRIEF kernel on already-sampled patches [R, 11, 11, 11]
    (the unoriented rows): :func:`brief_plain` in one launch, one block per
    row (``csrc/rotated_brief.cu``), into `out` (uint8 [R, 64]) when
    given."""
    if cuda_lib.route(patches) == "plain":
        return _plain_into(out, brief_plain(patches, variant, method, blur_sigma))
    cuda_lib.require_cuda(patches, "patches", torch.float32, 4)
    if tuple(patches.shape[1:]) != (PATCH_DIM,) * 3:
        raise ValueError(f"patches must be [R, 11, 11, 11], got {tuple(patches.shape)}")
    flat, dist, taps, r, code = _brief_args(variant, method, blur_sigma, patches.device)
    out = _desc_out(patches.shape[0], patches.device, out)
    if patches.shape[0]:
        cuda_lib.launch("sift3d_brief", patches, flat, dist, taps, r, code, out, patches.shape[0],
                        device=patches.device)
    return out


def rotated_brief(gstack, lvl, centers, scales, oris, z0: int = 0, depth=None, variant: str = "brief",
                  method: int = 2, blur_sigma: float = 0.95, out=None) -> torch.Tensor:
    """The fused BRIEF kernel: rotated 11^3 patches (K4's sampler) and their
    BRIEF, RRIEF or NRRIEF rank descriptors (pair table `method`, pre-blur
    `blur_sigma`) in one launch, one block per row; the patch stays in the
    block's shared memory. Sampling arguments as :func:`sample_rotated`;
    returns uint8 [R, 64] as :func:`rotated_brief_plain`, which runs for
    CPU tensors, in `out` when given."""
    if cuda_lib.route(gstack) == "plain":
        return _plain_into(out, rotated_brief_plain(gstack, lvl, centers, scales, oris, z0, depth, variant, method,
                                                    blur_sigma))
    r = _check_rows(gstack, lvl, centers, scales)
    z0, depth = _slab_args(gstack, z0, depth)
    cuda_lib.require_cuda(oris, "oris", torch.float32, 3)
    if oris.shape != (r, 3, 3) or oris.device != gstack.device:
        raise ValueError(f"oris must be [{r}, 3, 3] on {gstack.device}, got {tuple(oris.shape)}")
    flat, dist, taps, radius, code = _brief_args(variant, method, blur_sigma, gstack.device)
    nl, zd, yd, xd = gstack.shape
    out = _desc_out(r, gstack.device, out)
    if r:
        cuda_lib.launch(
            "sift3d_rotated_brief", gstack, lvl, centers, scales, oris, flat, dist, taps, radius, code, out, r,
            nl, zd, yd, xd, z0, depth, device=gstack.device,
        )
    return out
