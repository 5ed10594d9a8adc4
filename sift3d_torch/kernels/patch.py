"""Patch-local helpers: normalization, gradients, the structure tensor and
its closed-form eigendecomposition, histogram peaks.

PyTorch port of the non-sampler half of ``sift3d.kernels.patch``
(patch.py:38-71, 937-1144). The samplers themselves are the CUDA kernels
K2 and K4 in ``sift3d_torch.kernels.patch_cuda``.

Reference equivalents:
- Feature3D::NormalizeData (MultiScale.cpp:127-205): subtract mean, scale
  to unit L2 norm.
- fioGenerateEdgeImages3D (src_common/FeatureIO.cpp:2284-2326): central
  differences over interior voxels, zero borders.
- determineOrientation3D (MultiScale.cpp:2541-2607): structure tensor
  over the inscribed sphere and its eigenvectors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sift3d_torch.core.numerics import sqrt

PATCH_DIM = 11
PATCH_RAD = PATCH_DIM // 2


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a trailing axis of 3, summed left to right (the
    same rounding on every device, unlike a reduction kernel)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over a trailing axis of 3."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched analytic 3x3 inverse (MultiScale.h:192-222 invert_3x3)."""
    a11, a12, a13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a21, a22, a23 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a31, a32, a33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    det = (
        a11 * (a33 * a22 - a32 * a23)
        - a21 * (a33 * a12 - a32 * a13)
        + a31 * (a23 * a12 - a22 * a13)
    )
    inv_det = 1.0 / det
    out = torch.stack(
        [
            (a33 * a22 - a32 * a23),
            -(a33 * a12 - a32 * a13),
            (a23 * a12 - a22 * a13),
            -(a33 * a21 - a31 * a23),
            (a33 * a11 - a31 * a13),
            -(a23 * a11 - a21 * a13),
            (a32 * a21 - a31 * a22),
            -(a32 * a11 - a31 * a12),
            (a22 * a11 - a21 * a12),
        ],
        dim=-1,
    ).reshape(m.shape)
    return out * inv_det[..., None, None]


def patch_grid() -> np.ndarray:
    """Static [1331, 3] grid of (x, y, z) offsets in [-5, 5], z-major order
    matching data_zyx[z][y][x] layout."""
    r = np.arange(-PATCH_RAD, PATCH_RAD + 1, dtype=np.float32)
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)


def sphere_mask() -> np.ndarray:
    """Static voxels-within-radius mask: (v-5)^2 sum < 25 (strict),
    matching MultiScale.cpp:2584 with fRadius = 11/2 = 5 (int division)."""
    r = np.arange(PATCH_DIM) - PATCH_RAD
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return (zz * zz + yy * yy + xx * xx) < PATCH_RAD * PATCH_RAD


def rbox_max_scale(box: int) -> float:
    """Largest feature scale a box^3 bounding box covers exactly (the JAX
    package's boxed rotated sampler): 2*sqrt(3)*scale + 1.5 <= box/2."""
    return (box / 2.0 - 1.5) / (2.0 * math.sqrt(3.0))


def normalize_patches(patches: torch.Tensor) -> torch.Tensor:
    """Subtract mean, unit L2 norm (Feature3D::NormalizeData)."""
    n = patches.shape[0]
    flat = patches.reshape(n, -1)
    centered = flat - flat.mean(dim=1, keepdim=True)
    norm = sqrt((centered * centered).sum(dim=1, keepdim=True))
    return (centered / torch.where(norm > 0, norm, torch.ones_like(norm))).reshape(patches.shape)


def patch_gradients(patches: torch.Tensor) -> torch.Tensor:
    """Central differences, zero borders; returns [C, 3(dx,dy,dz), 11,11,11]."""
    interior = torch.zeros(patches.shape[1:], dtype=torch.bool, device=patches.device)
    interior[1:-1, 1:-1, 1:-1] = True

    def cd(axis):
        g = torch.roll(patches, -1, dims=axis) - torch.roll(patches, 1, dims=axis)
        return torch.where(interior, g, torch.zeros_like(g))

    # patches are [C, z, y, x]: dx is along axis 3, dy axis 2, dz axis 1
    return torch.stack([cd(3), cd(2), cd(1)], dim=1)


def sym_eigs_3x3(a: torch.Tensor):
    """Closed-form batched symmetric 3x3 eigendecomposition (descending).

    Trigonometric eigenvalues (the stable Cardano form) + Eberly's robust
    eigenvector scheme, the same steps as ``sift3d.kernels.patch.
    sym_eigs_3x3`` in f32. Returns (eigs [C, 3] descending, vecs [C, 3, 3]
    orthonormal columns, right-handed).
    """
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    # scale for numerical range (structure tensors span many decades)
    s = torch.clamp_min(
        torch.stack([a00, a11, a22, a01, a02, a12], -1).abs().amax(-1), 1e-30
    )
    b00, b11, b22 = a00 / s, a11 / s, a22 / s
    b01, b02, b12 = a01 / s, a02 / s, a12 / s

    # tensor divisors: PyTorch on CUDA multiplies by the reciprocal of a
    # scalar divisor, which would round differently from the CPU
    three = torch.full_like(b00, 3.0)
    q = (b00 + b11 + b22) / three
    p1 = b01 * b01 + b02 * b02 + b12 * b12
    p2 = (b00 - q) ** 2 + (b11 - q) ** 2 + (b22 - q) ** 2 + 2.0 * p1
    p = sqrt(torch.clamp_min(p2 / torch.full_like(p2, 6.0), 1e-38))
    c00, c11, c22 = (b00 - q) / p, (b11 - q) / p, (b22 - q) / p
    c01, c02, c12 = b01 / p, b02 / p, b12 / p
    detb = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / three
    e0 = q + 2.0 * p * torch.cos(phi)  # largest
    e2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e1 = 3.0 * q - e0 - e2
    # exactly diagonal-dominant degenerate case (p2 ~ 0): all eigs = q
    degen = p2 < 1e-30
    e0 = torch.where(degen, q, e0)
    e1 = torch.where(degen, q, e1)
    e2 = torch.where(degen, q, e2)

    b = torch.stack(
        [
            torch.stack([b00, b01, b02], -1),
            torch.stack([b01, b11, b12], -1),
            torch.stack([b02, b12, b22], -1),
        ],
        -2,
    )  # [..., 3, 3] scaled symmetric
    eye = torch.eye(3, dtype=b.dtype, device=b.device)

    def null_vec(lam, fallback):
        m = b - lam[..., None, None] * eye
        r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
        c01_ = cross3(r0, r1)
        c02_ = cross3(r0, r2)
        c12_ = cross3(r1, r2)
        n01 = dot3(c01_, c01_)
        n02 = dot3(c02_, c02_)
        n12 = dot3(c12_, c12_)
        best = torch.where(
            ((n01 >= n02) & (n01 >= n12))[..., None],
            c01_,
            torch.where((n02 >= n12)[..., None], c02_, c12_),
        )
        nb = torch.maximum(n01, torch.maximum(n02, n12))
        ok = nb > 1e-24
        v = best / sqrt(torch.where(ok, nb, torch.ones_like(nb)))[..., None]
        return torch.where(ok[..., None], v, fallback)

    def orth_plane(w):
        # unit w -> orthonormal u, v spanning its orthogonal plane
        wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
        use_x = wx.abs() > wy.abs()
        inv_xz = 1.0 / sqrt(torch.clamp_min(wx * wx + wz * wz, 1e-38))
        inv_yz = 1.0 / sqrt(torch.clamp_min(wy * wy + wz * wz, 1e-38))
        zero = torch.zeros_like(wx)
        ux = torch.where(use_x, -wz * inv_xz, zero)
        uy = torch.where(use_x, zero, wz * inv_yz)
        uz = torch.where(use_x, wx * inv_xz, -wy * inv_yz)
        u = torch.stack([ux, uy, uz], -1)
        return u, cross3(w, u)

    def middle_vec(w_simple, lam):
        # null vector of (b - lam I) restricted to the plane orthogonal to
        # the simple eigenvector: 2x2 symmetric null solve, row-pivoted
        u, v = orth_plane(w_simple)
        bu = dot3(b, u[..., None, :])
        bv = dot3(b, v[..., None, :])
        m00 = dot3(u, bu) - lam
        m01 = dot3(u, bv)
        m11 = dot3(v, bv) - lam
        use_r0 = m00.abs() >= m11.abs()
        ca = torch.where(use_r0, m01, m11)
        cb = torch.where(use_r0, -m00, -m01)
        n = sqrt(ca * ca + cb * cb)
        ok = n > 1e-24  # both rows ~0: e1 degenerate, any plane vector works
        n_safe = torch.where(ok, n, torch.ones_like(n))
        ca = torch.where(ok, ca / n_safe, torch.ones_like(ca))
        cb = torch.where(ok, cb / n_safe, torch.zeros_like(cb))
        return ca[..., None] * u + cb[..., None] * v

    ex = torch.zeros_like(b[..., 0, :])
    ex[..., 0] = 1.0
    # r >= 0: e1 crowds e2, so e0 is the safely-simple extreme; r < 0: e2 is
    simple_hi = r >= 0
    lam_simple = torch.where(simple_hi, e0, e2)
    w_simple = null_vec(lam_simple, ex)
    v1 = middle_vec(w_simple, e1)
    w_cross = cross3(w_simple, v1)
    # keep columns (v0, v1, v2) <-> (e0, e1, e2), right-handed v0 x v1 = v2
    v0 = torch.where(simple_hi[..., None], w_simple, cross3(v1, w_simple))
    v2 = torch.where(simple_hi[..., None], w_cross, w_simple)

    eigs = torch.stack([e0, e1, e2], -1) * s[..., None]
    vecs = torch.stack([v0, v1, v2], -1)  # columns
    # triple-degenerate (p2 ~ 0): eigenspace is everything; use identity
    vecs = torch.where(degen[..., None, None], eye, vecs)
    return eigs, vecs


def structure_tensor_eigs(patches_norm: torch.Tensor):
    """Gradient outer-product over the inscribed sphere -> sorted eigs/vecs.

    Port of determineOrientation3D (MultiScale.cpp:2541-2607): returns
    (eigs [C,3] descending, ori [C,3,3] with eigenvectors in COLUMNS).
    """
    grads = patch_gradients(patches_norm)  # [C, 3, z, y, x]
    m = torch.from_numpy(sphere_mask()).to(device=patches_norm.device, dtype=patches_norm.dtype)
    flat = (grads * m).reshape(grads.shape[0], 3, -1)
    tensor = torch.bmm(flat, flat.transpose(1, 2))  # [C, 3, 3]
    return sym_eigs_3x3(tensor)


def local_peaks_3d(vols: torch.Tensor) -> torch.Tensor:
    """Strict 26-neighbour peaks over the last 3 axes, interior only
    (regFindFEATUREIOPeaks on orientation histograms,
    MultiScale.cpp:1987-2121)."""
    z, y, x = vols.shape[-3:]
    pad = torch.nn.functional.pad(vols, (1, 1, 1, 1, 1, 1))
    is_max = torch.ones(vols.shape, dtype=torch.bool, device=vols.device)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                is_max &= vols > pad[..., 1 + dz : 1 + dz + z, 1 + dy : 1 + dy + y, 1 + dx : 1 + dx + x]
    interior = torch.zeros((z, y, x), dtype=torch.bool, device=vols.device)
    interior[1:-1, 1:-1, 1:-1] = True
    return is_max & interior
