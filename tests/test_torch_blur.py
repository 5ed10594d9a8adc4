"""PyTorch port: the Gaussian blur (K7's plain version) against the
ascending fused multiply-add chain that K7 computes, and against the JAX
package.

- The plain blur (banded torch.matmul on the CPU) equals, bit for bit, one
  f32 fma chain per output over the in-range taps in ascending order from
  acc = 0 (`fma_chain_blur3d`, numpy, each fma exact: an f64 product, an
  f64 sum and a correction at f32 rounding midpoints). That is what
  csrc/blur3d.cu computes, so on the card K7 equals the CPU's plain blur.
- Against JAX's eager gauss.blur3d at 64^3: exactly (XLA's CPU dot sums the
  taps in the same order at this shape; ROADMAP.md, Queue 3).
- Against the Pallas kernel K7 replaces, run in interpret mode on
  tests/test_gauss.py's shape, at that test's rtol 1e-5 / atol 1e-6 (the
  Pallas kernel adds its taps in another order).
- blur3d on a batch against the compiled JAX blur3d_batched on 11^3 patches:
  within 2 ulp of each patch's peak (XLA orders the batched einsum's sums
  its own way; 68% of values differ by about one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig
from sift3d.kernels import gauss as jx_gauss
from sift3d.kernels.gauss_pallas import blur3d_pallas
from sift3d_torch.core.config import initial_blur_sigma
from sift3d_torch.kernels import gauss, gauss_cuda

torch.set_num_threads(1)
CFG = SiftConfig()
# the initial blur (1.5199), the five level blurs (radii 3..8) and the
# -2+ initial blur (1.249)
PYRAMID_SIGMAS = [1.5199, *CFG.incremental_sigmas(), 1.249]


def _fma(a, b, c):
    """Exactly rounded f32 fma(a, b, c) of f32 arrays."""
    p = a.astype(np.float64) * b.astype(np.float64)  # exact: 48 bits
    c64 = c.astype(np.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)  # s + err == p + c exactly (two-sum)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    toward_s = np.where(s > rd, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32)
    n = np.nextafter(r, toward_s)
    nd = n.astype(np.float64)
    # s rounds to r; only at an exact midpoint between r and n does the
    # error term decide, and then it decides for n when it points at n
    mid = (s != rd) & (s == (rd + nd) * 0.5)
    take_n = mid & (err != 0) & ((err > 0) == (nd > rd))
    return np.where(take_n, n, r)


def fma_chain_axis(v, taps, axis):
    """One axis pass: acc = fma(taps[i - o + r], v[i], acc) over in-range i
    ascending, acc from 0."""
    v = np.moveaxis(v, axis, -1)
    n, r = v.shape[-1], len(taps) // 2
    o = np.arange(n)
    acc = np.zeros_like(v)
    for k in range(2 * r + 1):
        i = o - r + k
        src = v[..., np.clip(i, 0, n - 1)]
        acc = np.where((i >= 0) & (i < n), _fma(np.full_like(src, taps[k]), src, acc), acc)
    return np.moveaxis(acc, -1, axis)


def fma_chain_blur3d(v, sigma):
    taps = gauss.gaussian_kernel_1d(sigma, 0.01)
    out = v
    for axis in (-1, -2, -3):  # x, then y, then z
        out = fma_chain_axis(out, taps, out.ndim + axis)
    return out


def test_fma_reference_rounds_exactly():
    """The numpy fma agrees with exact rational arithmetic, midpoints
    included."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.uniform(-1e-6, 1e-6, 4000))).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies halfway between two f32
    # values; a term far below the f64 sum's last bit decides the rounding
    m = np.float32(1.0 + 2**-12)
    a = np.append(a, [m, m, m])
    b = np.append(b, [m, m, m])
    c = np.append(c, [np.float32(2**-70), np.float32(-(2**-70)), np.float32(0.0)])
    got = _fma(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda t: (abs(Fraction(float(t)) - exact), int(t.view(np.int32)) & 1))
        assert g == best, (x, y, z, g, best)


@pytest.mark.parametrize("n", [48, 64, 91])
@pytest.mark.parametrize("sigma", PYRAMID_SIGMAS)
def test_plain_blur_is_the_ascending_fma_chain(n, sigma):
    vol = np.random.default_rng(n).standard_normal((n, n, n)).astype(np.float32)
    got = gauss.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy()
    np.testing.assert_array_equal(got, fma_chain_blur3d(vol, sigma))


def test_plain_batched_blur_is_the_ascending_fma_chain_per_axis():
    """The BRIEF pre-blur's shape: [C, 11, 11, 11], sigma 0.95 (radius 2),
    each axis pass and the whole blur."""
    vols = np.random.default_rng(5).standard_normal((300, 11, 11, 11)).astype(np.float32)
    t = torch.from_numpy(vols)
    taps = gauss.gaussian_kernel_1d(0.95, 0.01)
    assert len(taps) == 5
    for axis in (0, 1, 2):
        got = gauss.blur_axis(t, axis, 0.95, 0.01).numpy()
        np.testing.assert_array_equal(got, fma_chain_axis(vols, taps, 1 + axis))
    np.testing.assert_array_equal(gauss.blur3d(t, 0.95, 0.01).numpy(), fma_chain_blur3d(vols, 0.95))


@pytest.mark.parametrize("sigma", PYRAMID_SIGMAS)
def test_plain_blur_equals_jax_at_64(sigma):
    vol = np.random.default_rng(64).standard_normal((64, 64, 64)).astype(np.float32)
    want = np.asarray(jx_gauss.blur3d(jnp.asarray(vol), sigma, 0.01))
    np.testing.assert_array_equal(gauss.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy(), want)


@pytest.mark.parametrize("sigma", [0.8, 2.45])
def test_plain_blur_matches_the_pallas_kernel(sigma):
    vol = np.random.default_rng(1234).standard_normal((9, 14, 21)).astype(np.float32)
    want = np.asarray(blur3d_pallas(jnp.asarray(vol), sigma, 0.01, interpret=True))
    got = gauss_cuda.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_batched_blur_matches_compiled_jax_within_2_ulp():
    vols = np.random.default_rng(9).standard_normal((300, 11, 11, 11)).astype(np.float32)
    want = np.asarray(jax.jit(jx_gauss.blur3d_batched, static_argnums=(1, 2))(jnp.asarray(vols), 0.95, 0.01))
    got = gauss.blur3d(torch.from_numpy(vols), 0.95, 0.01).numpy()
    peak = np.abs(vols).reshape(300, -1).max(axis=1)
    tol = 2 * np.spacing(peak.astype(np.float32))[:, None, None, None]
    differ = float((got != want).mean())
    print(f"values differing from compiled JAX: {differ:.3f}")
    assert (np.abs(got - want) <= tol).all()


def test_sigma_zero_and_the_initial_blur_rule():
    vol = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 6, 7)).astype(np.float32))
    assert gauss_cuda.blur3d(vol, 0.0) is vol
    # -2+ halves the voxel, so the input holds sigma_init / 0.5 = 1.0
    assert initial_blur_sigma(CFG) == pytest.approx(1.5199, abs=1e-4)
    assert initial_blur_sigma(CFG, 0.5) == pytest.approx(np.sqrt(1.6**2 - 1.0), abs=1e-12)
    assert len(gauss.gaussian_kernel_1d(initial_blur_sigma(CFG, 0.5), 0.01)) // 2 == 3
    radii = [len(gauss.gaussian_kernel_1d(s, 0.01)) // 2 for s in CFG.incremental_sigmas()]
    assert radii == [3, 4, 5, 6, 8] and max(radii) <= gauss_cuda.MAX_RADIUS
