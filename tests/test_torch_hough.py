"""PyTorch port: the Hough vote (M3's plain version) and match_keys against
the JAX package.

- ``hough.hough_similarity`` on the CPU against
  ``sift3d.match.hough.hough_similarity`` on tests/test_match.py's
  similarity fixtures (test_hough_recovers_similarity,
  test_match_keys_end_to_end), plus one with outliers and orientation
  noise: the same hypothesis, inliers and score, rotation and scale within
  1e-6.
- The hypotheses' rotations and scales equal the JAX scorer's bit for bit:
  the port carries XLA's fma contractions there (``hough.hypotheses``).
- ``pairwise.match_keys`` against the JAX ``match_keys``: the same ratio-
  sorted matches, inliers and transform.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.core.featureset import FeatureSet as JxFeatureSet
from sift3d.match import hough as jx_hough
from sift3d.match import pairwise as jx_pairwise
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.match import hough, pairwise

torch.set_num_threads(1)


def _random_feats(n, rng, desc=None):
    """tests/test_match.py's _random_feats, on the port's FeatureSet."""
    f = FeatureSet.empty(n)
    f.xyz = rng.uniform(20, 80, (n, 3)).astype(np.float32)
    f.scale = rng.uniform(2, 6, (n,)).astype(np.float32)
    q = rng.standard_normal((n, 3, 3))
    for i in range(n):
        u, _, vt = np.linalg.svd(q[i])
        r = u @ vt
        if np.linalg.det(r) < 0:
            r[2] = -r[2]
        f.ori[i] = r
    f.eigs = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    f.info[:] = INFO_FLAG_REORIENT
    f.desc = desc if desc is not None else rng.permuted(np.tile(np.arange(64.0, dtype=np.float32), (n, 1)), axis=1)
    return f


def _jx(f):
    return JxFeatureSet(xyz=f.xyz, scale=f.scale, ori=f.ori, eigs=f.eigs, info=f.info, desc=f.desc)


def _similar_pair(rng, n, deg, s, t, noise=0.0, outliers=0):
    """tests/test_match.py:52-91: f1 = the similarity (rotation about z by
    deg, scale s, translation t) of f2; noise on f1's locations and
    orientations, and `outliers` matches relocated at random."""
    f2 = _random_feats(n, rng)
    th = np.deg2rad(deg)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float64)
    f1 = f2.select(np.arange(n))
    f1.xyz = (s * (f2.xyz @ rot.T) + np.asarray(t) + rng.normal(0, noise, (n, 3))).astype(np.float32)
    f1.scale = (f2.scale * s).astype(np.float32)
    f1.ori = np.einsum("ij,njk->nik", rot, f2.ori.transpose(0, 2, 1)).transpose(0, 2, 1)
    f1.ori = (f1.ori + rng.normal(0, noise * 0.05, f1.ori.shape)).astype(np.float32)
    if outliers:
        f1.xyz[:outliers] = rng.uniform(20, 80, (outliers, 3)).astype(np.float32)
    return f1, f2, rot


CASES = {
    "test_hough_recovers_similarity": dict(n=40, deg=20, s=1.5, t=(4.0, -3.0, 2.0)),
    "test_match_keys_end_to_end": dict(n=60, deg=10, s=1.2, t=(5.0, 1.0, -2.0)),
    "noisy with outliers": dict(n=120, deg=-35, s=0.8, t=(-6.0, 2.5, 9.0), noise=1.5, outliers=30),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hough_equals_jax(case, rng):
    f1, f2, rot = _similar_pair(rng, **CASES[case])
    args = dict(pts0=f2.xyz, pts1=f1.xyz, s0=f2.scale, s1=f1.scale, o0=f2.ori, o1=f1.ori)
    want = jx_hough.hough_similarity(**args, prob=np.ones(len(f2), np.float32), cfg=JxConfig())
    got = hough.hough_similarity(**args, device="cpu")
    assert got["hypothesis"] == want["hypothesis"]
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    assert got["score"] == want["score"] == got["inliers"].sum()
    np.testing.assert_allclose(got["rot"], want["rot"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-6)
    np.testing.assert_allclose(got["rot"], rot, atol=0.05)
    if case == "noisy with outliers":
        assert 0 < got["score"] < len(f2) - 20  # the outliers and the noisy tail fail


def test_hypotheses_equal_the_jax_scorer_bit_for_bit(rng):
    """Orientations as read from .key text (six decimals, not quite
    orthonormal), scales 1.5-9: the rotation and scale of every hypothesis
    equal the JAX scorer's, which needs XLA's fma contractions."""
    m = 384
    f1, f2, _ = _similar_pair(rng, m, 25, 1.1, (1.0, 2.0, 3.0), noise=2.0)
    o0 = np.round(f2.ori, 6).astype(np.float32)
    o1 = np.round(f1.ori, 6).astype(np.float32)
    s0 = rng.uniform(1.5, 9, m).astype(np.float32)
    s1 = rng.uniform(1.5, 9, m).astype(np.float32)
    _, rots, scales = jx_hough._hough_scores(
        jnp.asarray(f2.xyz), jnp.asarray(f1.xyz), jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(o0),
        jnp.asarray(o1), jnp.ones(m), jnp.ones(m, bool), thres_scale=1.0, thres_trans=2.0, thres_orien=0.7,
    )
    got_r, got_s = hough.hypotheses(*(torch.from_numpy(a) for a in (s0, s1, o0, o1)))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(rots))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scales))


def test_scores_chunks_are_independent(rng):
    """The plain scorer's hypothesis chunks do not change the counts."""
    f1, f2, _ = _similar_pair(rng, 70, 15, 1.3, (2.0, 2.0, 2.0), noise=1.0, outliers=10)
    t = [torch.from_numpy(a) for a in (f2.xyz, f1.xyz, f2.scale, f1.scale, f2.ori, f1.ori)]
    rots, scales = hough.hypotheses(t[2], t[3], t[4], t[5])
    th = (1.0, 2.0, float(np.float32(0.7)))
    whole = hough.hough_scores_plain(*t, th)
    one = torch.cat([hough.hough_ok(rots[h : h + 1], scales[h : h + 1], t[0][h : h + 1], t[1][h : h + 1], *t, th)
                     .sum(dim=1, dtype=torch.int32) for h in range(70)])
    assert torch.equal(whole, one)
    assert whole.dtype == torch.int32 and int(whole.max()) > 40


@pytest.mark.parametrize("case", ["test_match_keys_end_to_end", "noisy with outliers"])
def test_match_keys_equals_jax(case, rng):
    f1, f2, _ = _similar_pair(rng, **CASES[case])
    want = jx_pairwise.match_keys(_jx(f1), _jx(f2))
    got = pairwise.match_keys(f1, f2, device="cpu")
    np.testing.assert_array_equal(got.model_idx, want.model_idx)
    np.testing.assert_array_equal(got.input_idx, want.input_idx)
    np.testing.assert_array_equal(got.inlier, want.inlier)
    assert got.num_inliers == want.num_inliers
    assert got.transform.scale == want.transform.scale
    np.testing.assert_array_equal(got.transform.rot, want.transform.rot)
    np.testing.assert_array_equal(got.transform.trans, want.transform.trans)
