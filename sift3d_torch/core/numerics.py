"""f32 operations that round the same way on every device.

The port's CPU path is the reference its CUDA path is held against, and
both are held against the JAX package's compiled CPU code, so an f32
result must not depend on which PyTorch kernel computed it. Each helper
computes in f64 and then rounds to f32, or sums in one fixed order, the
same way on every device.
"""

from __future__ import annotations

import torch


def fma_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 fma a * b + c, on every device: a CUDA
    kernel's fmaf, and the multiply-add XLA's CPU code contracts.

    The product is exact in f64. The f64 sum is made round-to-odd (an
    inexact sum with an even last bit moves to its neighbour toward the
    exact value, which TwoSum gives exactly), and rounding a round-to-odd
    f64 value to f32 rounds the exact value once (53 >= 24 + 2 bits). The
    plain f64 sum rounded to f32 would round twice, and miss the fma where
    that sum lands on a midpoint between two f32 values. Every operation is
    IEEE f64, so the card and the CPU compute the same bits."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


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
    midpoint between two f32 values, about once in 2^28. The CUDA kernels
    compute ``(float)acos((double)x)``."""
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


def numpy_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's order (the pairwise sum of
    ``np.add.reduce`` along a contiguous axis), the same on every device.

    Fewer than 8 elements: left to right. Up to 128: 8 running sums over
    blocks of 8, combined as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 +
    r7)), then the rest left to right. Longer: the two halves (the first a
    multiple of 8 long) summed alike, then added. The group vote's sums
    over a query's neighbours and over the labels use it, so they equal
    the JAX package's numpy sums bit for bit."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    if n < 8:
        res = x[..., 0]
        for i in range(1, n):
            res = res + x[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[..., :8]
        for i in range(8, m, 8):
            r = r + x[..., i : i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    half = n // 2
    half -= half % 8
    return numpy_sum(x[..., :half]) + numpy_sum(x[..., half:])
