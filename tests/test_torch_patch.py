"""PyTorch port: the patch samplers (K2 and K4's plain forms) and the eigen
stage against the JAX package, on the same numpy inputs.

Tolerance 1e-5 relative to the volume's largest value: both sides
interpolate in f32, but the JAX samplers contract one-hot weight matrices
with XLA dots, whose summation order (and fused multiply-adds) differ from
the plain form's explicit two-tap sums. Decisions (the eigen keep rule)
must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig
from sift3d.kernels import patch as jx_patch
from sift3d.pipeline import features as jx_features
from sift3d_torch.kernels import patch as tx_patch
from sift3d_torch.kernels.patch_cuda import sample_identity, sample_rotated
from sift3d_torch.pipeline import features as tx_features
from sift3d_torch.utils.synthetic import synthetic_blob_texture

torch.set_num_threads(1)
CFG = SiftConfig()
DIMS = (40, 44, 46)


@pytest.fixture(scope="module")
def gstack():
    vol = synthetic_blob_texture(DIMS, seed=5, n_blobs=40)
    return np.stack([vol * (1.0 - 0.1 * k) for k in range(6)]).astype(np.float32)


def _rows(rng, n, scale_lo, scale_hi, margin):
    lvl = rng.integers(1, 4, n).astype(np.int32)
    scales = rng.uniform(scale_lo, scale_hi, n).astype(np.float32)
    hi = np.array([DIMS[2], DIMS[1], DIMS[0]], np.float32)
    centers = rng.uniform(margin, hi - margin, (n, 3)).astype(np.float32)
    return lvl, centers, scales


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return q.astype(np.float32)


def _close(got, want, gstack):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(gstack).max()))


def test_identity_sampler_matches_boxed(rng, gstack):
    # in-bounds rows, as the bounds test guarantees for every kept candidate
    lvl, centers, scales = _rows(rng, 24, 1.6, 6.0, margin=15.0)
    want = np.asarray(jx_patch.sample_patches_identity_boxed(
        jnp.asarray(gstack), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales)
    ))
    got = sample_identity(
        torch.from_numpy(gstack), torch.from_numpy(lvl), torch.from_numpy(centers),
        torch.from_numpy(scales),
    ).numpy()
    _close(got, want, gstack)


@pytest.mark.parametrize("box", [24, 48, 64])
def test_rotated_sampler_matches_boxed_inside_its_bound(rng, gstack, box):
    bound = tx_patch.rbox_max_scale(box)
    assert abs(bound - jx_patch.rbox_max_scale(box)) < 1e-12
    lvl, centers, scales = _rows(rng, 16, 1.0, bound, margin=2.0)
    oris = _rotations(rng, 16)
    want = np.asarray(jx_patch.sample_patches_rotated_boxed(
        jnp.asarray(gstack), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales),
        jnp.asarray(oris), box=box,
    ))
    got = sample_rotated(*(torch.from_numpy(a) for a in (gstack, lvl, centers, scales, oris))).numpy()
    _close(got, want, gstack)


def test_rotated_sampler_matches_leveled_at_all_scales(rng, gstack):
    # boxless semantics at any scale: large scales, borders, x outside -> 0
    lvl, centers, scales = _rows(rng, 20, 1.0, 14.0, margin=-3.0)
    oris = _rotations(rng, 20)
    want = np.asarray(jx_patch.sample_patches_leveled(
        jnp.asarray(gstack), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales),
        jnp.asarray(oris),
    ))
    got = sample_rotated(*(torch.from_numpy(a) for a in (gstack, lvl, centers, scales, oris))).numpy()
    _close(got, want, gstack)
    assert (got == 0).any()  # some points left the volume in x


def test_eig_stage_matches_jax(rng, gstack):
    lvl, centers, scales = _rows(rng, 64, 3.2, 6.0, margin=15.0)
    patches = np.array(jx_patch.sample_patches_identity_boxed(
        jnp.asarray(gstack), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales)
    ))
    j_pn, j_eigs, j_ori, j_keep = (np.asarray(t) for t in jx_features.eig_stage(jnp.asarray(patches), CFG))
    t_pn, t_eigs, t_ori, t_keep = (t.numpy() for t in tx_features.eig_stage(torch.from_numpy(patches), CFG))
    np.testing.assert_allclose(t_pn, j_pn, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_eigs, j_eigs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_ori, j_ori, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_keep, j_keep)
    assert 0 < t_keep.sum() < len(t_keep)


def test_invert_3x3_and_grid_match_jax(rng):
    m = rng.standard_normal((50, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tx_patch.invert_3x3(torch.from_numpy(m)).numpy(), np.asarray(jx_patch.invert_3x3(jnp.asarray(m)))
    )
    np.testing.assert_array_equal(tx_patch.patch_grid(), jx_patch._GRID)
    np.testing.assert_array_equal(tx_patch.sphere_mask(), jx_patch.sphere_mask())
