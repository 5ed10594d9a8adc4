"""PyTorch port end to end against the JAX package on the CPU: the 48^3
cells (the blob fixtures of tests/test_pipeline_e2e.py and
synthetic_volume(48)).

XLA's CPU dot sums the x-axis blur taps in four interleaved partial sums
at 48 (test_blur_order_witness), so the two pyramids differ by a few ulp
and candidates whose DoG margin is that small flip. The port's own
pipeline is printed against JAX's; the witness feeds JAX's own pyramid
into the port's feature stage, and then counts, keypoints and flags agree
exactly.
"""

import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.kernels import gauss as jx_gauss
from sift3d.pipeline import extract as jx_extract_mod
from sift3d.pipeline import pyramid as jx_pyramid
from sift3d.pipeline.extract import extract_features as jx_extract
from sift3d_torch.kernels import gauss as tx_gauss
from sift3d_torch.pipeline import pyramid as tx_pyramid
from sift3d_torch.pipeline.extract import extract_features
from sift3d_torch.utils.synthetic import repeatability, synthetic_volume

torch.set_num_threads(1)


def _blob_volume(dims=(48, 48, 48), blobs=(((24, 24, 24), 3.0, 1.0),)):
    """tests/test_pipeline_e2e.py's fixture: sum of ((x, y, z), sigma, amp) blobs."""
    z, y, x = np.mgrid[0 : dims[0], 0 : dims[1], 0 : dims[2]].astype(np.float32)
    vol = np.zeros(dims, np.float32)
    for (bx, by, bz), s, a in blobs:
        vol += a * np.exp(-(((x - bx) ** 2 + (y - by) ** 2 + (z - bz) ** 2) / (2 * s * s)))
    return vol


def _noisy_blob_fixtures():
    rng = np.random.default_rng(3)
    v1 = _blob_volume(blobs=(((24, 24, 24), 3.0, 1.0), ((12, 34, 20), 2.2, -0.8)))
    v2 = _blob_volume(blobs=(((30, 14, 26), 2.6, 1.2), ((20, 20, 36), 3.4, 0.9)))
    v1 += 0.01 * rng.standard_normal(v1.shape).astype(np.float32)
    v2 += 0.01 * rng.standard_normal(v2.shape).astype(np.float32)
    return {"blob48_a": v1, "blob48_b": v2}


CELLS_48 = {
    **{name: (lambda name=name: _noisy_blob_fixtures()[name]) for name in ("blob48_a", "blob48_b")},
    "blob48_single": _blob_volume,
    "synthetic48_s7": lambda: synthetic_volume(48, seed=7),
}
# Rows with identical descriptors on JAX's pyramid. The single centred blob
# is radially symmetric: its GoH bins and orientation-histogram peaks tie
# exactly, so the last-bit patch differences (module docstring) swap ranks
# and peaks on 2.1% of its rows (ROADMAP.md, Queue 3).
DESC_EQUAL_48 = {"blob48_single": 0.975}


def _jax_octaves(vol):
    """(gstack, dogs, mask) of every octave as the JAX package's compiled
    dense phase computes them for this volume, as CPU tensors."""
    cfg = JxConfig()
    n_oct = jx_pyramid.num_octaves(vol.shape, cfg)
    sizes, (dz, dy, _) = [], vol.shape
    for _ in range(n_oct):
        sizes.append(min(8 * cfg.max_candidates_per_level, 3 * dz * dy))
        dz, dy = dz // 2, dy // 2
    outs, _ = jx_extract_mod._phase1_program(
        np.stack([vol]), cfg, n_oct, tuple(sizes), 1.0, False
    )
    return [tuple(torch.from_numpy(np.array(o[k][0])) for k in ("gstack", "dogs", "mask")) for o in outs]


@pytest.mark.parametrize("cell", sorted(CELLS_48))
def test_extract_matches_jax_on_48_cells(cell, monkeypatch):
    vol = CELLS_48[cell]()
    want = jx_extract(vol, JxConfig())
    own = extract_features(vol)
    rep_own = (repeatability(own, want)[0], repeatability(want, own)[0])
    print(f"{cell}: own pyramid: jax {len(want)} features, port {len(own)}, repeatability {rep_own}")
    if cell != "blob48_single":  # its exact ties flip on ulp-level pyramid differences
        assert rep_own == (1.0, 1.0)
        assert abs(len(own) - len(want)) <= 0.02 * len(want)
    # witness: the port's feature stage on the JAX package's own pyramid
    octaves = iter(_jax_octaves(vol))
    monkeypatch.setattr(tx_pyramid, "initial_blur_core", lambda img, cfg: img)
    monkeypatch.setattr(tx_pyramid, "octave_core", lambda base, cfg: (*next(octaves), base))
    got = extract_features(vol)
    desc_eq = (got.desc == want.desc).all(axis=1).mean() if len(got) == len(want) else 0.0
    print(f"{cell}: jax pyramid: port {len(got)} features, identical descriptors {desc_eq:.4f}")
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.info, want.info)
    assert desc_eq >= DESC_EQUAL_48.get(cell, 0.99)


@pytest.mark.parametrize("dim", [48, 64])
def test_blur_order_witness(dim):
    """Where the two pyramids part: the JAX package's x-axis blur equals the
    port's torch.matmul at 64 and, at 48, a sum over four interleaved tap
    lanes instead (XLA's CPU dot); the y and z passes agree at both."""
    vol = np.random.default_rng(0).standard_normal((dim,) * 3).astype(np.float32)
    sigma = JxConfig().incremental_sigmas()[0]
    t = torch.from_numpy(vol)
    for axis in (0, 1, 2):
        want = np.asarray(jx_gauss.blur_axis(vol, axis, sigma, 0.01))
        got = tx_gauss.blur_axis(t, axis, sigma, 0.01).numpy()
        if axis < 2 or dim == 64:
            np.testing.assert_array_equal(got, want)
            continue
        assert not np.array_equal(got, want)
        band = torch.from_numpy(tx_gauss.banded_matrix(dim, sigma, 0.01).copy())
        lanes = [torch.matmul(t[..., j::4], band[j::4]) for j in range(4)]
        np.testing.assert_array_equal(((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])).numpy(), want)


def test_extract_finds_the_blob_centre():
    """test_pipeline_e2e's single-blob check, on the port."""
    feats = extract_features(_blob_volume())
    peaks = feats.select(feats.is_peak & ~feats.is_reoriented)
    d = np.linalg.norm(peaks.xyz - np.array([24.5, 24.5, 24.5]), axis=1)
    assert d.min() < 1.5
    near = peaks.select(d < 1.5)
    assert (near.scale > 3.0).any() and (near.scale < 12.0).all()
    np.testing.assert_array_equal(np.sort(feats.desc[:5], axis=1), np.tile(np.arange(64), (5, 1)))
