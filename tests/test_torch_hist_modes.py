"""PyTorch port: K8 (raw splat) and K9 (blurred histogram + peak plane),
the plain forms, against the JAX package's Pallas kernels in interpret
mode and its CPU histogram; and K9's top-k against K3's plain form.

Tolerance rtol = atol = 2e-5 against JAX, as tests/test_hist_pallas.py
holds its kernels: the Pallas kernels sum the splat as MXU dots, in
another order. Peak planes are equal where the margin to the nearest
neighbour exceeds that. On the same rows, the top-k of K9's peak plane is
K3's output bit for bit: one accumulation, in one order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig
from sift3d.kernels.gauss import gaussian_kernel_1d
from sift3d.kernels.hist_pallas import smooth_histogram_peaks as jx_peaks
from sift3d.kernels.hist_pallas import splat_histogram_raw as jx_raw
from sift3d.pipeline import features as jx_features
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.kernels.hist_cuda import (
    hist_band, hist_topk_plain, peak_rows, smooth_histogram, smooth_histogram_peaks,
    smooth_histogram_peaks_bins, splat_histogram_raw,
)

torch.set_num_threads(1)
CFG = SiftConfig()
TAPS = gaussian_kernel_1d(CFG.ori_hist_blur_sigma, 0.01)
BAND = torch.from_numpy(hist_band(TAPS))
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture()
def coords():
    """tests/test_hist_pallas.py's fixture: unit directions scaled into the
    histogram (0.5-centred) plus exact border values (saturation path)."""
    rng = np.random.default_rng(17)
    c, v = 13, 333
    e = rng.standard_normal((c, v, 3)).astype(np.float32)
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-6)
    xyz = e * 5.0 + 5.5
    xyz[:, :5] = np.float32([0.2, 10.6, 5.5])
    w = np.abs(rng.standard_normal((c, v))).astype(np.float32)
    w[:, -7:] = 0.0
    return xyz, w


def _jx(xyz, w):
    return [jnp.asarray(xyz[..., i]) for i in range(3)] + [jnp.asarray(w)]


def _tx(xyz, w):
    return [torch.from_numpy(np.ascontiguousarray(xyz[..., i])) for i in range(3)] + [torch.from_numpy(w)]


def test_raw_splat_matches_jax(coords):
    xyz, w = coords
    got = splat_histogram_raw(*_tx(xyz, w)).numpy()
    assert got.shape == (13, 11, 11, 11)
    np.testing.assert_allclose(got, np.asarray(jx_raw(*_jx(xyz, w), interpret=True)), **TOL)
    want = np.asarray(jx_features._splat_histogram(jnp.asarray(xyz), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **TOL)
    # the splat conserves each row's weight
    np.testing.assert_allclose(got.sum(axis=(1, 2, 3)), w.sum(axis=1), rtol=1e-5)


def test_smooth_histogram_matches_jax(coords):
    xyz, w = coords
    got = smooth_histogram(*_tx(xyz, w), CFG.ori_hist_blur_sigma).numpy()
    want = np.asarray(jx_features._smooth_histogram(jnp.asarray(xyz), jnp.asarray(w), CFG.ori_hist_blur_sigma))
    np.testing.assert_allclose(got, want, **TOL)


def test_peaks_match_jax_interpret(coords):
    xyz, w = coords
    hist, pk = (t.numpy() for t in smooth_histogram_peaks(*_tx(xyz, w), BAND))
    hb_j, pk_j = jx_peaks(*_jx(xyz, w), tuple(float(t) for t in TAPS), interpret=True)
    c = xyz.shape[0]
    # the TPU's [C, 128, 16] p-layout sliced to the natural one (test_hist_pallas.py:63)
    hb_j = np.asarray(hb_j)[:, :121, :11].reshape(c, 11, 11, 11)
    pk_j = np.asarray(pk_j)[:, :121, :11].reshape(c, 11, 11, 11)
    np.testing.assert_allclose(hist, hb_j, **TOL)
    # peak planes agree wherever the peak test is decided by more than the tolerance
    pad = np.pad(hist, ((0, 0), (1, 1), (1, 1), (1, 1)), constant_values=-np.inf)
    gap = np.full(hist.shape, np.inf)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz or dy or dx:
                    nb = pad[:, 1 + dz : 12 + dz, 1 + dy : 12 + dy, 1 + dx : 12 + dx]
                    gap = np.minimum(gap, np.abs(hist - nb))
    clear = gap > 2e-5 + 2e-5 * np.abs(hist)
    assert clear.mean() > 0.75
    np.testing.assert_array_equal(np.isfinite(pk)[clear], np.isfinite(pk_j)[clear])
    fin = np.isfinite(pk) & np.isfinite(pk_j)
    np.testing.assert_allclose(pk[fin], pk_j[fin], **TOL)
    assert np.isfinite(pk).sum() >= c


@pytest.mark.parametrize("k", [4, 6, 11])
def test_topk_of_peaks_is_k3(coords, k):
    """K9's peak plane, taken to its top k, is K3's output bit for bit."""
    xyz, w = coords
    bins = [torch.from_numpy(np.ascontiguousarray(xyz[..., i] - np.float32(0.5))) for i in range(3)]
    hist, pk = smooth_histogram_peaks_bins(*bins, torch.from_numpy(w), BAND)
    want = hist_topk_plain(*bins, torch.from_numpy(w), BAND, k)
    assert torch.equal(peak_rows(hist, pk, k), want)


def test_cpu_tensors_take_the_plain_path(coords, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    xyz, w = coords
    entries = ("sift3d_splat_histogram_raw", "sift3d_smooth_histogram_peaks")
    before = [launches(e) for e in entries]
    splat_histogram_raw(*_tx(xyz, w))
    smooth_histogram_peaks(*_tx(xyz, w), BAND)
    assert [launches(e) for e in entries] == before
    with pytest.raises(ValueError, match="no kernel for device"):
        splat_histogram_raw(*[t.to("meta") for t in _tx(xyz, w)])
