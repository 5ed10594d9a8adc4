"""f32 operations that round the same way on every device.

The port's CPU path is the reference its CUDA path is held against, and
both are held against the JAX package's compiled CPU code, so an f32
result must not depend on which PyTorch kernel computed it. Each helper
computes in f64 and then rounds to f32, the same way on every device.
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
