"""PyTorch port: the orientation-histogram top-k (K3's plain form) and the
canonical-orientation stage against the JAX package.

K3 is held against both JAX forms: the CPU path (_smooth_histogram_axes +
_top_peaks + _interp_hist_peaks) and the Pallas kernel in interpret mode.
Histogram values equal the CPU path's to the bit (the same sums in the
same order) and the Pallas kernel's to rtol 1e-5 (its splat sums run in
another order); peak sets, their order and positions must be equal, and
exact ties go to the lowest flat index first. The canonical stage equals
the compiled JAX stage to the bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig
from sift3d.kernels import patch as jx_patch
from sift3d.kernels.gauss import gaussian_kernel_1d
from sift3d.kernels.hist_pallas import smooth_histogram_topk
from sift3d.pipeline import features as jx_features
from sift3d_torch.kernels.hist_cuda import hist_band, hist_topk
from sift3d_torch.pipeline import features as tx_features
from sift3d_torch.utils.synthetic import synthetic_blob_texture

torch.set_num_threads(1)
CFG = SiftConfig()
TAPS = gaussian_kernel_1d(CFG.ori_hist_blur_sigma, 0.01)
BAND = torch.from_numpy(hist_band(TAPS))


@pytest.fixture()
def coords():
    """tests/test_hist_pallas.py's fixture: unit directions scaled into the
    histogram plus exact border values (saturation path)."""
    rng = np.random.default_rng(17)
    c, v = 13, 333
    e = rng.standard_normal((c, v, 3)).astype(np.float32)
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-6)
    xyz = e * 5.0 + 5.5
    xyz[:, :5] = np.float32([0.2, 10.6, 5.5])
    w = np.abs(rng.standard_normal((c, v))).astype(np.float32)
    w[:, -7:] = 0.0
    return xyz, w


def _bins(xyz):
    """The JAX forms take 0.5-centred coordinates, the port bin coordinates
    (xyz - 0.5, exact here)."""
    return [torch.from_numpy(np.ascontiguousarray(xyz[..., i] - np.float32(0.5))) for i in range(3)]


def _port(xyz, w, k):
    return hist_topk(*_bins(xyz), torch.from_numpy(w), BAND, k).numpy()


@pytest.mark.parametrize("k", [6, 11])
def test_topk_matches_jax_cpu_path(coords, k):
    xyz, w = coords
    hist = jx_features._smooth_histogram_axes(
        *(jnp.asarray(xyz[..., i]) for i in range(3)), jnp.asarray(w), CFG.ori_hist_blur_sigma
    )
    vals, pz, py, px, valid = (np.asarray(t) for t in jx_features._top_peaks(hist, k))
    itp = np.asarray(jx_features._interp_hist_peaks(hist, jnp.asarray(pz), jnp.asarray(py), jnp.asarray(px)))
    out = _port(xyz, w, k)
    ok = np.isfinite(out[..., 0])
    np.testing.assert_array_equal(ok, valid)
    # the same splat sums in the same order: equal to the bit
    np.testing.assert_array_equal(out[..., 0][ok], vals[ok])
    flat = out[..., 7].astype(np.int64)
    np.testing.assert_array_equal((flat // 16 // 11)[ok], pz[ok])
    np.testing.assert_array_equal((flat // 16 % 11)[ok], py[ok])
    np.testing.assert_array_equal((flat % 16)[ok], px[ok])
    # the same neighbours feed the same quadratic: subvoxel peaks agree
    _, t_valid, t_itp = tx_features.hist_tops(*_bins(xyz), torch.from_numpy(w), BAND, k)
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    np.testing.assert_allclose(t_itp.numpy()[ok], itp[ok], rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [4, 6])
def test_topk_matches_pallas_interpret(coords, k):
    xyz, w = coords
    want = np.asarray(smooth_histogram_topk(
        *(jnp.asarray(xyz[..., i]) for i in range(3)), jnp.asarray(w),
        tuple(float(t) for t in TAPS), k, interpret=True,
    ))
    got = _port(xyz, w, k)
    ok = np.isfinite(want[..., 0])
    np.testing.assert_array_equal(np.isfinite(got[..., 0]), ok)
    np.testing.assert_array_equal(got[..., 7][ok], want[..., 7][ok])
    np.testing.assert_allclose(got[..., :7][ok], want[..., :7][ok], rtol=1e-5, atol=1e-6)


def test_topk_ties_take_the_lowest_flat_index():
    # two single-bin points at mirrored x: two peaks of exactly equal value
    xyz = np.full((2, 3, 3), 5.5, np.float32)
    xyz[0, 0, 0], xyz[0, 1, 0], xyz[0, 2, 0] = 7.5, 3.5, 9.5  # row 0: x = 7, 3, 9
    xyz[1, 0, 0], xyz[1, 1, 0], xyz[1, 2, 0] = 3.5, 7.5, 1.5  # row 1: x = 3, 7, 1
    w = np.array([[1.0, 1.0, 0.5], [1.0, 1.0, 0.5]], np.float32)
    got = _port(xyz, w, 4)
    want = np.asarray(smooth_histogram_topk(
        *(jnp.asarray(xyz[..., i]) for i in range(3)), jnp.asarray(w),
        tuple(float(t) for t in TAPS), 4, interpret=True,
    ))
    for out in (got, want):
        assert out[0, 0, 0] == out[0, 1, 0]  # an exact tie
        # lowest flat index first: x = 3 before x = 7, then the weaker x = 9 / 1
        np.testing.assert_array_equal(out[:, :3, 7] % 16, [[3, 7, 9], [3, 7, 1]])
        assert np.isneginf(out[:, 3, 0]).all()
    np.testing.assert_array_equal(got[:, :3, 7], want[:, :3, 7])
    np.testing.assert_allclose(got[:, :3, :7], want[:, :3, :7], rtol=1e-5)
    np.testing.assert_array_equal(got[:, 3, 7], [(1 * 11 + 1) * 16 + 1] * 2)  # empty slot


def test_canonical_stage_matches_jax():
    rng = np.random.default_rng(5)
    dims = (40, 40, 40)
    g = synthetic_blob_texture(dims, seed=3, n_blobs=40)[None]
    n = 48
    lvl = np.zeros(n, np.int32)
    centers = rng.uniform(14, 26, (n, 3)).astype(np.float32)
    scales = rng.uniform(3.2, 5.0, n).astype(np.float32)
    patches = jx_patch.sample_patches_identity_boxed(
        jnp.asarray(g), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales)
    )
    pn = np.array(jx_patch.normalize_patches(patches))
    want = jx_features.canonical_stage(jnp.asarray(pn), CFG)
    got = tx_features.canonical_stage(torch.from_numpy(pn), CFG)
    valid = np.asarray(want["ori_valid"])
    np.testing.assert_array_equal(got["ori_valid"].numpy(), valid)
    assert valid.sum() > n  # primaries with secondaries emitted
    # the compiled JAX stage's roundings, fused multiply-adds included
    np.testing.assert_array_equal(got["ori"].numpy()[valid], np.asarray(want["ori"])[valid])
