"""PyTorch port: K6's plain form (the extrema mask of precomputed DoGs)
against the JAX package's lax stencil and its Pallas kernel in interpret
mode, one volume and a batch, on the same numpy inputs. Exact: every
comparison is strict."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from sift3d.kernels import extrema as jx_extrema
from sift3d.kernels.extrema_pallas import extrema_mask_pallas
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.kernels.extrema_cuda import extrema_mask, extrema_mask_plain

torch.set_num_threads(1)


def _smooth_dogs(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    flat = d.reshape((-1,) + shape[-3:])
    return np.stack([ndi.gaussian_filter(x, 1.5) for x in flat]).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 12, 20, 36), (2, 5, 13, 20, 36)])
def test_extrema_mask_plain_matches_jax(rng, shape):
    d = _smooth_dogs(rng, shape)
    vols = d if d.ndim == 5 else d[None]
    want = np.stack([np.asarray(jx_extrema.extrema_mask(jnp.asarray(v))) for v in vols])
    want = want if d.ndim == 5 else want[0]
    pallas = np.asarray(extrema_mask_pallas(jnp.asarray(d), interpret=True))
    got = extrema_mask_plain(torch.from_numpy(d)).numpy()
    assert got.dtype == np.int8 and got.shape == shape[:-4] + (3,) + shape[-3:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert (got == 1).sum() > 0 and (got == -1).sum() > 0


def test_extrema_mask_cpu_routes_to_plain(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    d = torch.from_numpy(_smooth_dogs(rng, (2, 5, 7, 9, 11)))
    before = launches("sift3d_extrema_mask")
    assert torch.equal(extrema_mask(d), extrema_mask_plain(d))
    assert torch.equal(extrema_mask(d[1]), extrema_mask_plain(d)[1])
    assert launches("sift3d_extrema_mask") == before
    with pytest.raises(ValueError, match="no kernel for device"):
        extrema_mask(d.to("meta"))
