"""Volume resampling: 2x octave subsampling, 2x upsampling, the
interpolation rule and trilinear resampling.

Reference equivalents:
- subsample_2x:  fioSubSampleInterpolate (FeatureIO.cpp:1475-1554): each
                 output voxel is the mean of its 8 children (also the
                 CLI's `-2-`).
- double_size:   fioDoubleSize (FeatureIO.cpp:2453-2548): 2x linear
                 upsampling with edge clamping, the CLI's `-2+`.
- interp_coord:  _fioDetermineInterpCoord (FeatureIO.cpp:752-781), the
                 0.5-voxel-center convention every sampler here shares;
                 interp_bin is the same rule at bin coordinates (the
                 orientation histograms).
- trilinear_sample / isotropic_resample: fioGetPixelTrilinearInterp
                 (FeatureIO.cpp:813-852) and the `-w` resampling of
                 featExtract.cpp:118-204.

The JAX package runs double_size and isotropic_resample eagerly (one XLA
op at a time, nothing fused), so these plain f32 PyTorch ops in the same
order give the same bits on the CPU and on the card; the JAX package has
no Pallas kernel for them. On a batch, each has a hand-written kernel
that equals it bit for bit (``resample_cuda``): ``double_size_batch`` and
``isotropic_resample_batch``.
"""

from __future__ import annotations

import torch


def subsample_2x(vol: torch.Tensor) -> torch.Tensor:
    """Halve each spatial dimension of a [..., Z, Y, X] volume; each output
    voxel = mean of the 2x2x2 block (odd trailing voxels are dropped, as in
    the reference where out dims are in/2). The reshape-mean form of
    ``sift3d.kernels.resample.subsample_2x``."""
    z, y, x = vol.shape[-3:]
    lead = tuple(vol.shape[:-3])
    z2, y2, x2 = z // 2, y // 2, x // 2
    v = vol[..., : 2 * z2, : 2 * y2, : 2 * x2]
    v = v.reshape(lead + (z2, 2, y2, 2, x2, 2))
    # the 8 children summed in scan (z, y, x) order, the JAX package's
    # reduction order: bit-identical means on every device
    total = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                child = v[..., :, dz, :, dy, :, dx]
                total = child if total is None else total + child
    return total / 8.0


def interp_bin(u: torch.Tensor, dim: int):
    """Index + weight for 1D linear interpolation at bin coordinate u (the
    centre of bin i sits at u = i).

      u < 0        -> index 0,      weight 1 (clamp low)
      u >= dim - 1 -> index dim-2,  weight 0 (clamp high: all on dim-1)
      else         -> index floor(u), weight 1 - frac(u)
    Returns (i, w) where value = w * v[i] + (1 - w) * v[i + 1].
    """
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, dim - 2)
    w = 1.0 - (u - i.to(u.dtype))
    w = torch.where(u < 0.0, torch.ones_like(w), w)
    w = torch.where(u >= dim - 1, torch.zeros_like(w), w)
    return i, w


def interp_coord(c: torch.Tensor, dim: int):
    """interp_bin at voxel coordinate c, 0.5-center convention (voxel i's
    centre at c = i + 0.5). c - 0.5 is exact for c in [0.5, 2^23] and
    negative below 0.5, so the clamps are the reference's c < 0.5 and
    c >= dim - 0.5."""
    return interp_bin(c - 0.5, dim)


def double_size(vol: torch.Tensor) -> torch.Tensor:
    """2x linear upsampling of a [Z, Y, X] volume (``sift3d.kernels.
    resample.double_size``): out[2i] = in[i], out[2i+1] = 0.5 * (in[i] +
    in[i+1]) with the last cell clamped (in[i+1] -> in[i]); axes of length
    1 stay as they are. Axis order z, y, x, as there."""

    def up_axis(v, axis):
        a = v.movedim(axis, 0)
        nxt = torch.cat([a[1:], a[-1:]], dim=0)
        odd = 0.5 * (a + nxt)
        out = torch.stack([a, odd], dim=1).reshape((2 * a.shape[0],) + tuple(a.shape[1:]))
        return out.movedim(0, axis)

    out = vol
    for axis in range(3):
        if vol.shape[axis] > 1:
            out = up_axis(out, axis)
    return out.contiguous()


def trilinear_sample(vol: torch.Tensor, x, y, z) -> torch.Tensor:
    """Trilinear sample of a [Z, Y, X] volume at continuous (x, y, z)
    tensors of one shape, voxel centres at i + 0.5; coordinates outside
    the volume saturate at the border (``sift3d.kernels.resample.
    trilinear_sample``, the same six lerps in the same order)."""
    zd, yd, xd = vol.shape
    ix, wx = interp_coord(x, xd)
    iy, wy = interp_coord(y, yd)
    iz, wz = interp_coord(z, zd)

    def g(dz, dy, dx):
        return vol[iz + dz, iy + dy, ix + dx]

    n00 = wx * g(0, 0, 0) + (1.0 - wx) * g(0, 0, 1)
    n01 = wx * g(1, 0, 0) + (1.0 - wx) * g(1, 0, 1)
    n10 = wx * g(0, 1, 0) + (1.0 - wx) * g(0, 1, 1)
    n11 = wx * g(1, 1, 0) + (1.0 - wx) * g(1, 1, 1)
    nn0 = wy * n00 + (1.0 - wy) * n10
    nn1 = wy * n01 + (1.0 - wy) * n11
    return wz * nn0 + (1.0 - wz) * nn1


def isotropic_shape(shape_zyx, voxel_size) -> tuple:
    """The [Z, Y, X] of a [Z, Y, X] volume of voxel size (dx, dy, dz)
    resampled to the isotropic grid of its smallest voxel size: n_i * d_i
    / min(d), truncated (featExtract.cpp:118-204)."""
    dx, dy, dz = [float(v) for v in voxel_size]
    dmin = min(dx, dy, dz)
    zd, yd, xd = (int(n) for n in shape_zyx)
    return int(zd * dz / dmin), int(yd * dy / dmin), int(xd * dx / dmin)


def isotropic_resample(vol: torch.Tensor, voxel_size, out_dims=None):
    """Resample an anisotropic [Z, Y, X] volume to the isotropic grid of
    its smallest voxel size (the `-w` path, ``sift3d.kernels.resample.
    isotropic_resample``): out dims n_i * d_i / min(d)
    (:func:`isotropic_shape`; out_dims: (x, y, z) to override), samples at
    i * (min / d_i) + 0.5, computed in f32 as there. Returns (volume,
    min voxel size)."""
    dx, dy, dz = [float(v) for v in voxel_size]
    dmin = min(dx, dy, dz)
    ox, oy, oz = out_dims if out_dims is not None else isotropic_shape(vol.shape, voxel_size)[::-1]

    def centres(n, factor):
        # the factor as an f32 tensor: the JAX package rounds the Python
        # float to f32, then multiplies and adds in f32, one op at a time
        f = torch.tensor(factor, dtype=torch.float32, device=vol.device)
        return torch.arange(n, dtype=torch.float32, device=vol.device) * f + 0.5

    zg, yg, xg = torch.meshgrid(
        centres(oz, dmin / dz), centres(oy, dmin / dy), centres(ox, dmin / dx), indexing="ij"
    )
    return trilinear_sample(vol, xg, yg, zg), dmin
