"""Separable 3D Gaussian blur as banded f32 matmuls.

The reference implements the blur as three 1D FIR passes with zero-padded
borders (src_common/GaussBlur3D.cpp:329-479 `blur_3d_simpleborders`), with
the truncated filter size chosen by a tail-mass rule
(src_common/GaussianMask.cpp:12-57) and the filter L1-normalized after
generation (GaussBlur3D.cpp:1190-1201).

As in the JAX package (``sift3d.kernels.gauss``), a 1D FIR along an axis of
length L is a banded L x L matrix product: zero-padding falls out of the
matrix having no taps outside the volume. Here each pass is one
``torch.matmul`` in full f32 — TF32 is switched off where the port creates
its device (``sift3d_torch.core.device``), because TF32 in the blur flips
tie-margin extrema. It is never routed through a cuDNN convolution, whose
f32 default is TF32. A hand-written fused blur kernel is still to come.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def gaussian_filter_size(sigma: float, min_value: float) -> int:
    """Truncated filter length (odd) for a given sigma.

    Exact reimplementation of calculate_gaussian_filter_size
    (src_common/GaussianMask.cpp:12-57): grow the radius until the truncated
    tail holds at most ``min_value`` of the (discretely estimated) total
    mass. Returns 2*radius + 1.
    """
    if sigma == 0:
        return 1
    # Estimate total mass sum_{i=-inf..inf} exp(-i^2 / 2 sigma^2)
    cur_volume = 1.0
    new_volume = 1.0
    i = 0
    while True:
        i += 1
        cur_volume = new_volume
        new_volume = cur_volume + 2.0 * math.exp((i * i) / (-2.0 * sigma * sigma))
        if not (new_volume - cur_volume > 1e-5):
            break
    value = 1.0
    i = 1
    while value <= cur_volume * (1.0 - min_value):
        value += 2.0 * math.exp((i * i) / (-2.0 * sigma * sigma))
        i += 1
    i -= 1
    return 2 * i + 1


def gaussian_kernel_1d(sigma: float, min_value: float) -> np.ndarray:
    """L1-normalized 1D Gaussian FIR taps (float32).

    Matches generate_gaussian_filter1d (GaussianMask.cpp:300-326) followed
    by the explicit normalization in gb3d_blur3d_interleave
    (GaussBlur3D.cpp:1190-1201). sigma == 0 gives the delta filter.
    """
    size = gaussian_filter_size(sigma, min_value)
    if sigma <= 0.0:
        return np.ones((1,), dtype=np.float32)
    center = size // 2
    j = np.arange(size, dtype=np.float32) - np.float32(center)
    scale = np.float32(1.0 / (sigma * math.sqrt(2.0 * math.pi)))
    taps = scale * np.exp((j * j) / np.float32(sigma * sigma) / np.float32(-2.0))
    taps = taps.astype(np.float32)
    taps /= taps.sum(dtype=np.float32)
    return taps.astype(np.float32)


def band_from_taps(taps: np.ndarray, dim: int) -> np.ndarray:
    """Dense banded blur matrix B with zero-padding semantics.

    out[o] = sum_i x[i] * B[i, o],  B[i, o] = taps[i - o + r] for |i-o| <= r.
    Rows/columns outside the volume are simply absent, which is exactly the
    reference's zero-border behaviour.
    """
    taps = np.asarray(taps, np.float32)
    r = len(taps) // 2
    b = np.zeros((dim, dim), dtype=np.float32)
    for o in range(dim):
        lo = max(0, o - r)
        hi = min(dim, o + r + 1)
        b[lo:hi, o] = taps[lo - o + r : hi - o + r]
    return b


@functools.lru_cache(maxsize=None)
def _banded_matrix_cached(dim: int, sigma: float, min_value: float) -> np.ndarray:
    b = band_from_taps(gaussian_kernel_1d(sigma, min_value), dim)
    b.setflags(write=False)
    return b


def banded_matrix(dim: int, sigma: float, min_value: float) -> np.ndarray:
    """The [dim, dim] float32 banded matrix of a sigma blur (read-only)."""
    return _banded_matrix_cached(int(dim), float(sigma), float(min_value))


def blur_axis(vol: torch.Tensor, axis: int, sigma: float, min_value: float) -> torch.Tensor:
    """Blur one spatial axis of a [..., Z, Y, X] volume (0=Z, 1=Y, 2=X)."""
    dim = vol.shape[vol.ndim - 3 + axis]
    b = torch.from_numpy(banded_matrix(dim, sigma, min_value).copy()).to(vol.device)
    if axis == 2:
        return torch.matmul(vol, b)
    # move the blur axis last, contract, move it back
    src = vol.ndim - 3 + axis
    return torch.matmul(vol.movedim(src, -1), b).movedim(-1, src).contiguous()


def blur3d(vol: torch.Tensor, sigma: float, min_value: float = 0.01) -> torch.Tensor:
    """Separable 3D Gaussian blur with zero-padded borders, f32.

    Equivalent of gb3d_blur3d (GaussBlur3D.cpp:1262-1285): x pass, then y,
    then z, as the JAX package's ``gauss.blur3d``.
    """
    if sigma <= 0.0:
        return vol
    out = blur_axis(vol, 2, sigma, min_value)
    out = blur_axis(out, 1, sigma, min_value)
    out = blur_axis(out, 0, sigma, min_value)
    return out
