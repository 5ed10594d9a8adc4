"""PyTorch port: the CLI's resampling (-2+, -w) and world coordinates
against the JAX package.

The JAX CLI runs double_size, trilinear_sample and isotropic_resample
eagerly, one XLA op at a time with nothing fused, so the port's plain f32
ops in the same order must give the same bits: every comparison here is
exact. The voxel-to-world matrix and the similarity transform are host
numpy on both sides: exact too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.core.featureset import FeatureSet as JxFeatureSet
from sift3d.io import nifti as jx_nifti
from sift3d.kernels import resample as jx_resample
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.io import nifti
from sift3d_torch.kernels import resample

torch.set_num_threads(1)


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 100


@pytest.mark.parametrize("shape", [(7, 9, 11), (1, 6, 5), (16, 16, 16)])
def test_double_size_equals_jax(shape):
    vol = _vol(shape)
    want = np.asarray(jx_resample.double_size(jnp.asarray(vol)))
    got = resample.double_size(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_trilinear_sample_equals_jax():
    vol = _vol((9, 10, 12), seed=1)
    pts = np.random.default_rng(2).uniform(-2, 14, (3, 500)).astype(np.float32)
    pts = np.concatenate([pts, np.array([[0.5, 11.5, 12.0], [0.0, 9.5, 10.5], [8.5, 9.0, 3.25]], np.float32)], 1)
    want = np.asarray(jx_resample.trilinear_sample(jnp.asarray(vol), *(jnp.asarray(p) for p in pts)))
    got = resample.trilinear_sample(torch.from_numpy(vol), *(torch.from_numpy(p) for p in pts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("voxel_size", [(1.0, 1.0, 2.0), (0.9, 1.0, 1.3)])
def test_isotropic_resample_equals_jax(voxel_size):
    vol = _vol((12, 20, 18), seed=3)
    want, dmin_j = jx_resample.isotropic_resample(jnp.asarray(vol), voxel_size)
    got, dmin = resample.isotropic_resample(torch.from_numpy(vol), voxel_size)
    assert dmin == dmin_j
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("with_sform", [False, True])
def test_world_matrix_equals_jax(tmp_path, with_sform):
    path = str(tmp_path / "v.nii")
    qto = np.eye(4)
    qto[:3, :3] = _rotation(4) * np.array([1.0, 1.0, 2.0])
    qto[:3, 3] = [-90.0, 12.5, -70.25]
    sto = None
    if with_sform:
        sto = np.eye(4)
        sto[:3, :3] = _rotation(5) * np.array([1.0, 1.0, 2.0])
        sto[:3, 3] = [10.0, -20.0, 30.0]
    nifti.write(path, _vol((4, 5, 6)), voxel_size=(1.0, 1.0, 2.0), qto_xyz=qto, sto_xyz=sto)
    port, jax_vol = nifti.read_volume(path), jx_nifti.read_volume(path)
    for use_sform in (False, True):
        got = port.world_matrix(use_sform=use_sform)
        np.testing.assert_array_equal(got, jax_vol.world_matrix(use_sform=use_sform))
        # -ws takes the sform only where there is one
        want_src = sto if (use_sform and with_sform) else qto
        np.testing.assert_allclose(got, want_src, atol=1e-5)
    no_q = dataclasses.replace(port, qto_xyz=None)
    np.testing.assert_array_equal(no_q.world_matrix(), np.diag([1.0, 1.0, 2.0, 1.0]))


def test_similarity_transform_equals_jax():
    rng = np.random.default_rng(6)
    n = 40
    ori, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    fields = dict(
        xyz=rng.uniform(0, 64, (n, 3)).astype(np.float32),
        scale=rng.uniform(1, 10, n).astype(np.float32),
        ori=ori.astype(np.float32),
        eigs=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        info=rng.integers(0, 64, n).astype(np.uint32),
        desc=rng.integers(0, 64, (n, 64)).astype(np.float32),
    )
    m = np.eye(4)
    m[:3, :3] = _rotation(7) * np.array([0.9, 1.0, 1.3])
    m[:3, 3] = [-90.0, 12.5, -70.25]
    got = FeatureSet(**{k: v.copy() for k, v in fields.items()}).similarity_transform(m)
    want = JxFeatureSet(**{k: v.copy() for k, v in fields.items()}).similarity_transform(m)
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
