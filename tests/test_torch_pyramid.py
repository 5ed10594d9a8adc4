"""PyTorch port: blur, subsample and one octave against the JAX package.

Tolerances: the blur is an f32 banded matmul on both sides, but XLA's CPU
dot and PyTorch's sgemm may sum the taps in different orders (XLA picks
its order per shape), so Gaussian levels agree to rtol 1e-5 / atol 1e-6 (a
few ulp). A DoG is the difference of two such levels, so its error is
absolute: at most 1e-6 of the stack's largest value. The 8-voxel subsample
mean agrees to an ulp of its inputs (atol 1e-6 of their largest value). The int8 extrema mask must be equal; a
flip is reported with its DoG margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig
from sift3d.kernels import gauss as jx_gauss
from sift3d.kernels import resample as jx_resample
from sift3d.pipeline import pyramid as jx_pyramid
from sift3d_torch.kernels import gauss, resample
from sift3d_torch.pipeline import pyramid
from sift3d_torch.utils.synthetic import synthetic_volume

torch.set_num_threads(1)
CFG = SiftConfig()
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [32, 48])
@pytest.mark.parametrize("sigma", [1.2262, 3.0897])
def test_blur3d_matches_jax(n, sigma):
    vol = synthetic_volume(n)
    want = np.asarray(jx_gauss.blur3d(jnp.asarray(vol), sigma, 0.01))
    got = gauss.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_filter_taps_match_jax():
    for sigma in [0.5, 0.95, 1.5199, *CFG.incremental_sigmas()]:
        np.testing.assert_array_equal(
            gauss.gaussian_kernel_1d(sigma, 0.01), jx_gauss.gaussian_kernel_1d(sigma, 0.01)
        )
        np.testing.assert_array_equal(
            gauss.banded_matrix(37, sigma, 0.01), jx_gauss._banded_matrix(37, sigma, 0.01)
        )


@pytest.mark.parametrize("shape", [(32, 32, 32), (9, 14, 11)])
def test_subsample_2x_matches_jax(rng, shape):
    vol = rng.standard_normal(shape).astype(np.float32) * 100
    want = np.asarray(jx_resample.subsample_2x(jnp.asarray(vol), mxu=False))
    got = resample.subsample_2x(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(vol).max()))


def test_interp_coord_matches_jax(rng):
    c = np.concatenate([rng.uniform(-3, 14, 500), [0.0, 0.5, 10.5, 11.0, 9.99]]).astype(np.float32)
    i_j, w_j = jx_resample._interp_coord(jnp.asarray(c), 11)
    i_t, w_t = resample.interp_coord(torch.from_numpy(c), 11)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # the same rule at bin coordinates (K3's input): u = c - 0.5 is exact
    i_b, w_b = resample.interp_bin(torch.from_numpy(c - np.float32(0.5)), 11)
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(w_b.numpy(), np.asarray(w_j))


def _mask_flips(got, want, dogs):
    idx = np.argwhere(got != want)
    return [
        (tuple(int(v) for v in i), int(want[tuple(i)]), int(got[tuple(i)]),
         float(dogs[i[0] + 1, i[1], i[2], i[3]]))
        for i in idx[:10]
    ]


@pytest.mark.parametrize("n", [32, 48])
def test_octave_matches_jax(n):
    base = np.asarray(jx_pyramid.initial_blur(jnp.asarray(synthetic_volume(n)), CFG))
    want = jx_pyramid.octave_step(jnp.asarray(base), CFG)
    gstack, dogs, mask, next_base = pyramid.octave_core(torch.from_numpy(base.copy()), CFG)
    np.testing.assert_allclose(gstack.numpy(), np.asarray(want.gstack), **TOL)
    dog_atol = 1e-6 * float(np.abs(np.asarray(want.gstack)).max())
    np.testing.assert_allclose(dogs.numpy(), np.asarray(want.dogs), rtol=0, atol=dog_atol)
    np.testing.assert_allclose(next_base.numpy(), np.asarray(want.next_base), **TOL)
    got_mask, want_mask = mask.numpy(), np.asarray(want.mask)
    flips = _mask_flips(got_mask, want_mask, np.asarray(want.dogs))
    if flips:
        print("extrema flips (index, jax, port, jax DoG value):", flips)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert (want_mask != 0).sum() > 0


def test_initial_blur_and_octave_count():
    vol = synthetic_volume(24)
    want = np.asarray(jx_pyramid.initial_blur(jnp.asarray(vol), CFG))
    got = pyramid.initial_blur_core(torch.from_numpy(vol), CFG).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for shape in [(48, 48, 48), (2, 48, 48), (182, 218, 182)]:
        assert pyramid.num_octaves(shape, CFG) == jx_pyramid.num_octaves(shape, CFG)
