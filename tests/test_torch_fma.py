"""The port's multiply-adds round once, as a CUDA kernel's fmaf and the
multiply-adds XLA's CPU code contracts do: ``numerics.fma_exact`` against
exact rational arithmetic on constructed near-midpoint triples, and the
plain versions that run it (K3's splat, the refinement determinant) against
a numpy fma chain on such triples.

A triple (a, b, c) is near a midpoint when a * b + c lies within an f64 ulp
of a point halfway between two f32 values without lying on it: the f64 sum
then rounds onto the midpoint, and rounding that to f32 (round half to
even) can land on the wrong side. The triples are built with c in +-[1, 2)
and a * b close to half of c's f32 ulp, so about half of them break a
double-rounded multiply-add.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.kernels import hist_cuda
from sift3d_torch.kernels.extrema import _det3

from test_torch_blur import _fma as numpy_fma

P = hist_cuda.PATCH_DIM


def round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the rational x, ties to even."""
    lo = np.float32(float(x))
    cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - x), int(t.view(np.int32)) & 1))


def exact_fma(a, b, c) -> np.ndarray:
    return np.array([round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def double_rounded(a, b, c) -> np.ndarray:
    """The f64 sum of the exact product rounded to f32: two roundings."""
    return (a.astype(np.float64) * b + c.astype(np.float64)).astype(np.float32)


def near_midpoint(b: np.ndarray, rng):
    """For each b, a random c in +-[1, 2) and a = half of c's ulp / b in f32;
    returns (a, c, near): near marks the rows whose exact a * b + c lies
    within 2^-53 |c| of the f32 midpoint next to c, off it."""
    m = len(b)
    c = (rng.uniform(1.0, 2.0, m) * rng.choice([-1.0, 1.0], m)).astype(np.float32)
    half_ulp = np.abs(np.spacing(c)).astype(np.float64) / 2
    a = (np.sign(c) * half_ulp / b).astype(np.float32)  # a * b has c's sign
    near = np.zeros(m, bool)
    for i, (x, y, z, h) in enumerate(zip(a, b, c, half_ulp)):
        off = abs(Fraction(float(x)) * Fraction(float(y))) - Fraction(float(h))
        near[i] = off != 0 and abs(off) < Fraction(float(abs(z))) / 2**53
    return a, c, near


def near_midpoint_triples(n: int, seed: int):
    """n triples (a, b, c), b uniform in [0.25, 1), near a midpoint."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(o[0]) for o in out) < n:
        b = rng.uniform(0.25, 1.0, 4096).astype(np.float32)
        a, c, near = near_midpoint(b, rng)
        out.append((a[near], b[near], c[near]))
    return tuple(np.concatenate(v)[:n] for v in zip(*out))


def test_witness_rounds_once():
    a, b, c = np.float32(0.76267713), np.float32(7.815187e-08), np.float32(1.7214884)
    got = fma_exact(*(torch.tensor([v]) for v in (a, b, c))).numpy()[0]
    assert got == np.float32(1.7214884)
    assert got == exact_fma([a], [b], [c])[0]
    assert double_rounded(np.array([a]), np.array([b]), np.array([c]))[0] == np.float32(1.7214885)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_exact_on_near_midpoint_triples(seed):
    a, b, c = near_midpoint_triples(2000, seed)
    want = exact_fma(a, b, c)
    got = fma_exact(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(numpy_fma(a, b, c), want)
    # the triples have teeth: a double-rounded multiply-add misses many
    assert (double_rounded(a, b, c) != want).sum() > 200


def test_fma_exact_on_random_and_special_triples():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(3000).astype(np.float32)
    b = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, 1e-45], np.float32)
    grid = np.array(np.meshgrid(special, special, special)).reshape(3, -1)
    a, b, c = (np.concatenate([x, g]) for x, g in zip((a, b, c), grid))
    got = fma_exact(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    finite = np.isfinite(got)
    np.testing.assert_array_equal(got[finite], exact_fma(a[finite], b[finite], c[finite]))
    np.testing.assert_array_equal(got, numpy_fma(a, b, c))


def test_det3_is_the_fma_chain():
    """kernels/extrema._det3 (the refinement's Cramer determinants; fmaf in
    csrc/identity_eig.cu) on near-midpoint triples: with p1 = q1 = 0,
    p2 = 1, q3 = c, p3 = -a and q2 = b its chain ends in fma(a, b, c); and
    on random rows against the numpy chain."""
    a, b, c = near_midpoint_triples(2000, 7)
    zero, one = np.zeros_like(a), np.ones_like(a)
    args = [torch.from_numpy(v) for v in (zero, one, -a, zero, b, c)]
    np.testing.assert_array_equal(_det3(*args).numpy(), exact_fma(a, b, c))

    rng = np.random.default_rng(8)
    p1, p2, p3, q1, q2, q3 = rng.standard_normal((6, 4000)).astype(np.float32)
    t = numpy_fma(p1, q2, -(p1 * q3))
    t = numpy_fma(-p2, q1, t)
    t = numpy_fma(p3, q1, t)
    t = numpy_fma(p2, q3, t)
    want = numpy_fma(-p3, q2, t)
    got = _det3(*(torch.from_numpy(v) for v in (p1, p2, p3, q1, q2, q3))).numpy()
    np.testing.assert_array_equal(got, want)


def test_k3_splat_is_the_fma_chain():
    """K3's plain splat (hist_cuda.splat_blur_plain, fmaf in
    csrc/hist_topk.cu) under the identity band, on rows of two points: the
    first at bin (5, 5, 5) with weight c, the second at (5 + tx, 5 + ty, 5)
    with weight a, whose x and y weights 1 - tx and 1 - ty make its
    in-plane product b at that bin. Each row's bin (5, 5, 5) then ends in
    fma(a, b, c), near a midpoint; the whole histogram equals the numpy fma
    chain (fz * (fy * fx) added into the chunk's sum in point order)."""
    rng = np.random.default_rng(11)
    steps = 2.0**-21  # the grid of 5 + t
    tx, ty, a, c = [], [], [], []
    while len(a) < 600:
        t = (rng.integers(2**20, 2**21, (2, 4096)) * steps).astype(np.float32)  # in [0.5, 1)
        b = (np.float32(1.0) - t[0]) * (np.float32(1.0) - t[1])
        aa, cc, near = near_midpoint(b, rng)
        tx += list(t[0, near])
        ty += list(t[1, near])
        a += list(aa[near])
        c += list(cc[near])
    tx, ty, a, c = (np.array(v[:600], np.float32) for v in (tx, ty, a, c))
    r, five = len(a), np.full(len(a), 5.0, np.float32)
    cx = torch.from_numpy(np.stack([five, five + tx], 1))
    cy = torch.from_numpy(np.stack([five, five + ty], 1))
    cz = torch.from_numpy(np.stack([five, five], 1))
    w = np.stack([c, a], 1)
    hist = hist_cuda.splat_blur_plain(cx, cy, cz, torch.from_numpy(w), torch.eye(P)).numpy()
    b = (np.float32(1.0) - tx) * (np.float32(1.0) - ty)
    want = exact_fma(a, b, c)
    np.testing.assert_array_equal(hist[:, 5, 5, 5], want)
    assert (double_rounded(a, b, c) != want).sum() > 60

    def weights(t):  # the two points' [r, 2, 11] axis weights
        f = np.zeros((r, 2, P), np.float32)
        f[:, 0, 5] = 1.0
        f[:, 1, 5], f[:, 1, 6] = np.float32(1.0) - t, t
        return f

    fx, fy = weights(tx), weights(ty)
    part = np.zeros((r, P, P, P), np.float32)
    for v in range(2):
        inplane = fy[:, v, None, :, None] * fx[:, v, None, None, :]
        fz = np.zeros((r, P, 1, 1), np.float32)
        fz[:, 5] = w[:, v, None, None]
        part = numpy_fma(np.broadcast_to(fz, part.shape).copy(), np.broadcast_to(inplane, part.shape).copy(), part)
    np.testing.assert_array_equal(hist, part)
