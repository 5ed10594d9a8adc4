"""Reference extraction under featExtract's -2+: the volume doubled, then
the features of ``extract.features``, in the input's voxel coordinates.

``double_size`` is fioDoubleSize (FeatureIO.cpp:2453-2548) written from its
description, in NumPy: along z, then y, then x, every voxel i of an axis of
n > 1 voxels gives two, out[2i] = v[i] and out[2i + 1] = 0.5 * (v[i] +
v[i + 1]), with v[n] read as v[n - 1] (the edge clamped); an axis of one
voxel stays as it is. Each sum and product is an f32 operation.

``features`` extracts the doubled volume with featExtract's -2+ settings
(the initial blur assumes the doubled image's sigma_init, 0.5 / 0.5 = 1.0)
and halves every location and scale (featExtract.cpp:422-427, 502-505).
It imports neither the JAX package nor the program. ``control=True``: the
blur in TF32, as in ``extract.features``.
"""

from __future__ import annotations

import numpy as np

from reference import extract

f32 = np.float32


def _double_axis(v: np.ndarray, axis: int) -> np.ndarray:
    n = v.shape[axis]
    if n == 1:
        return v
    nxt = np.take(v, np.minimum(np.arange(n) + 1, n - 1), axis=axis)
    mid = (f32(0.5) * (v + nxt)).astype(f32)
    shape = list(v.shape)
    shape[axis] = 2 * n
    out = np.empty(shape, f32)
    even = [slice(None)] * v.ndim
    odd = [slice(None)] * v.ndim
    even[axis], odd[axis] = slice(0, None, 2), slice(1, None, 2)
    out[tuple(even)] = v
    out[tuple(odd)] = mid
    return out


def double_size(vol: np.ndarray) -> np.ndarray:
    """A [Z, Y, X] volume doubled as fioDoubleSize doubles it, f32."""
    out = np.asarray(vol, f32)
    for axis in range(3):
        out = _double_axis(out, axis)
    return np.ascontiguousarray(out)


def features(vol: np.ndarray, sift: dict, descriptor: str, control: bool = False) -> dict:
    """The features of one [Z, Y, X] volume under -2+ (``extract.features``'
    fields), in the input volume's voxel coordinates."""
    if "sigma_init" in sift:
        raise ValueError("-2+ sets sigma_init itself")
    out = extract.features(double_size(vol), dict(sift, sigma_init=1.0), descriptor, control=control)
    return dict(out, xyz=(out["xyz"] * f32(0.5)).astype(f32), scale=(out["scale"] * f32(0.5)).astype(f32))
