"""PyTorch port: DoG + extrema (K1's plain form) and the quadratic vertex
against the JAX package, on the same numpy inputs. Exact."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from sift3d.kernels import extrema as jx_extrema
from sift3d.kernels.extrema_pallas import dogs_extrema_pallas
from sift3d_torch.kernels import extrema as tx_extrema
from sift3d_torch.kernels.extrema_cuda import dogs_extrema, dogs_extrema_plain

torch.set_num_threads(1)


def _smooth_stack(rng, shape):
    g = rng.standard_normal(shape).astype(np.float32)
    return np.stack([ndi.gaussian_filter(x, 1.5) for x in g]).astype(np.float32)


# the shapes of tests/test_extrema.py's Pallas DoG tests (odd z, tz=1 slab)
@pytest.mark.parametrize("shape", [(6, 12, 20, 36), (6, 5, 9, 17), (6, 3, 9, 17)])
def test_dogs_extrema_plain_matches_jax(rng, shape):
    g = _smooth_stack(rng, shape)
    want_dogs = g[:-1] - g[1:]
    want_mask = np.asarray(jx_extrema.extrema_mask(jnp.asarray(want_dogs)))
    pallas_dogs, pallas_mask = dogs_extrema_pallas(jnp.asarray(g), interpret=True)
    dogs, mask = dogs_extrema_plain(torch.from_numpy(g))
    np.testing.assert_array_equal(dogs.numpy(), want_dogs)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(dogs.numpy(), np.asarray(pallas_dogs))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(pallas_mask))


def test_dogs_extrema_cpu_routes_to_plain(rng):
    g = torch.from_numpy(_smooth_stack(rng, (6, 7, 8, 9)))
    dogs, mask = dogs_extrema(g)
    want_dogs, want_mask = dogs_extrema_plain(g)
    assert mask.dtype == torch.int8 and dogs.dtype == torch.float32
    assert torch.equal(dogs, want_dogs) and torch.equal(mask, want_mask)


def test_extrema_mask_single_peak_and_plateau():
    dogs = torch.zeros((3, 5, 5, 5))
    dogs[1, 2, 2, 2] = 1.0
    assert tx_extrema.extrema_mask(dogs)[0, 2, 2, 2] == 1
    dogs[1, 2, 2, 2] = -1.0
    assert tx_extrema.extrema_mask(dogs)[0, 2, 2, 2] == -1
    dogs[1, 2, 2, 3] = -1.0  # a tie is no extremum (strict comparisons)
    assert (tx_extrema.extrema_mask(dogs) != 0).sum() == 0


def test_quadratic_interp_matches_compiled_jax(rng):
    """The vertex equals the JAX package's compiled (jit) evaluation bit for
    bit, including near-degenerate fits where the f32 determinants cancel."""
    n = 50000
    f = (rng.standard_normal((3, n)) * 10).astype(np.float32)
    f[:, :100] = f[1, :100]  # flat fits
    xs = rng.integers(1, 220, n).astype(np.float32)
    args = (f[0], f[1], f[2], xs - 1, xs, xs + 1)
    want = np.asarray(jax.jit(jx_extrema.quadratic_interp_1d)(*[jnp.asarray(a) for a in args]))
    got = tx_extrema.quadratic_interp_1d(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)
    # a symmetric parabola peaks at its centre; f(x) = -(x - 2.25)^2 at 2.25
    one = torch.ones(1)
    assert float(tx_extrema.quadratic_interp_1d(one, 2 * one, one, one, 2 * one, 3 * one)) == 2.0
    fx = [-((v - 2.25) ** 2) * one for v in (1.0, 2.0, 3.0)]
    vertex = float(tx_extrema.quadratic_interp_1d(*fx, one, 2 * one, 3 * one))
    assert abs(vertex - 2.25) < 1e-5
