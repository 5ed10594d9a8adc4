"""f32 operations that round the same way on every device.

The port's CPU path is the reference its CUDA path is held against, and
both are held against the JAX package's compiled CPU code, so an f32
result must not depend on which PyTorch kernel computed it. Each helper
computes in f64 and then rounds to f32, or sums in one fixed order, the
same way on every device.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 multiply-add a * b + c, almost always equal to the f32 fma.

    PyTorch has no fma op, and whether its CPU or CUDA kernels fuse a
    multiply into an add is up to their compilers; the compiled JAX package
    contracts many multiply-adds into fmas. Here the product is exact in
    f64, but the sum is rounded twice, to f64 and then to f32. Where the
    exact sum fits in 53 bits (the exponents of a * b and c lie close) that
    is the fma's single rounding; otherwise it differs from the fma only
    when the f64 sum lands exactly halfway between two f32 values, about
    one sum in 2^28. Both devices compute it alike, so the card and the CPU
    agree either way."""
    return (a.double() * b.double() + c.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.

    PyTorch's vectorized CPU sqrt is off by one ulp on about 0.7% of f32
    inputs (AVX-512 build); CUDA's sqrtf and XLA's CPU sqrt are correctly
    rounded. The f64 root of an f32 value rounds to the correctly rounded
    f32 root."""
    return torch.sqrt(x.double()).float()


def acos(x: torch.Tensor) -> torch.Tensor:
    """f32 arccos through f64, the same on every device.

    PyTorch's f32 arccos has one polynomial on the CPU and another on the
    card. Their f64 results lie within an ulp of f64 of the true value, so
    both round to the same f32 unless the true value lies that close to a
    midpoint between two f32 values, about once in 2^28 (as for
    :func:`fma`). The CUDA kernels compute ``(float)acos((double)x)``."""
    return torch.acos(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine through f64, the same on every device (see :func:`acos`);
    the kernels compute ``(float)cos((double)x)``."""
    return torch.cos(x.double()).float()


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order, the same on every device
    and for every batch size.

    The axis is zero-padded to the next power of two n, then halved until
    one element is left: each step adds element i + n/2 to element i
    (``x[..., :h] + x[..., h:]``, h = n/2). A library reduction picks its
    order by device and shape; this pairing does not move, and the CUDA
    kernels sum in it (``csrc/common.cuh``: ``tree_sum_2048`` for the 1331
    voxels of a patch, ``warp_tree_sum_64`` for a descriptor)."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
