"""PyTorch port: M2's plain version (the ratio test with the geometric-
compatibility shuffle) against the JAX package.

``pairwise.ratio_match`` on the CPU (the closed form, ``ratio_rows_plain``)
against ``sift3d.match.pairwise.ratio_match`` (numpy's closed form) and
``_ratio_match_sequential_oracle`` (the reference's state machine, which
the kernel runs), on integer descriptors, as read from .key files (the
distances are exact integers in any order): equal indices and bit-equal
ratios. The database holds clusters of geometrically compatible
near-copies, so every branch of the state machine fires
(compatible-replace, incompatible-shuffle, second-slot displacement,
init-pair retention); the test counts them in the oracle's walk.

The int8 route's cut of the database (ratio_rows_split_plain: segments of
16 rows, an exclusive scan of their minima, each walked from the state
that enters it) equals the closed form and the JAX ratio_match on
tie-heavy rows at D in {2, 3, 127, 128, 129, 969}, at the kernel's
segment and at others; the route follows the data as M1's does.
"""

import numpy as np
import pytest
import torch

from sift3d_torch.kernels import knn_cuda

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.core.featureset import FeatureSet as JxFeatureSet
from sift3d.match import pairwise as jx_pairwise
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.match import pairwise

torch.set_num_threads(1)


def _feats(n, rng, desc=None):
    f = FeatureSet.empty(n)
    f.xyz = rng.uniform(20, 80, (n, 3)).astype(np.float32)
    f.scale = rng.uniform(2, 6, (n,)).astype(np.float32)
    f.info[:] = INFO_FLAG_REORIENT
    f.desc = desc if desc is not None else rng.permuted(np.tile(np.arange(64.0, dtype=np.float32), (n, 1)), axis=1)
    return f


def _jx(f):
    return JxFeatureSet(xyz=f.xyz, scale=f.scale, ori=f.ori, eigs=f.eigs, info=f.info, desc=f.desc)


def _swap_ranks(desc, rng, swaps):
    """A near-copy of a rank row: `swaps` random transpositions."""
    out = desc.copy()
    for _ in range(swaps):
        a, b = rng.integers(0, 64, 2)
        out[a], out[b] = out[b], out[a]
    return out


def _clustered(rng, nd=90, nq=60):
    db = _feats(nd, rng)
    # features 3k+1, 3k+2 are compatible near-copies of 3k: nearby, at a
    # similar scale, with a few ranks swapped
    for k in range(0, nd - 2, 3):
        for o in (1, 2):
            db.xyz[k + o] = db.xyz[k] + rng.normal(0, 0.4, 3).astype(np.float32)
            db.scale[k + o] = db.scale[k] * np.float32(np.exp(rng.normal(0, 0.2)))
            db.desc[k + o] = _swap_ranks(db.desc[k], rng, int(rng.integers(1, 4)))
    q = _feats(nq, rng)
    picks = rng.integers(0, nd, nq - 10)
    q.desc[: nq - 10] = np.stack([_swap_ranks(db.desc[p], rng, int(rng.integers(1, 6))) for p in picks])
    return q, db


def _events(q, db, cfg):
    """Which branches of the sequential machine the oracle's walk takes."""
    d = jx_pairwise.dist_sqr_matrix(q.desc, db.desc)
    seen = set()
    for qi in range(len(q)):
        m1, i1, m2 = d[qi, 0], 0, d[qi, 1]
        if m2 < m1:
            m1, m2, i1 = m2, m1, 1
        for j in range(2, len(db)):
            dj = d[qi, j]
            if dj < m2:
                dist = float(np.linalg.norm(db.xyz[j] - db.xyz[i1]))
                compat = abs(float(np.log(db.scale[j] / db.scale[i1]))) < cfg.ratio_compat_log_scale and (
                    dist < cfg.ratio_compat_shift * float(db.scale[j]))
                seen.add(("new min" if dj < m1 else "second", "compatible" if compat else "incompatible"))
                if dj < m1:
                    m2 = m2 if compat else m1
                    m1, i1 = dj, j
                elif not compat:
                    m2 = dj
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_jax_and_the_sequential_oracle(seed):
    rng = np.random.default_rng(seed)
    q, db = _clustered(rng)
    cfg = JxConfig()
    got = pairwise.ratio_match(q, db, device="cpu")
    want = jx_pairwise.ratio_match(_jx(q), _jx(db), cfg)
    oracle = jx_pairwise._ratio_match_sequential_oracle(_jx(q), _jx(db), cfg)
    for ref in (want, oracle):
        np.testing.assert_array_equal(got.query_idx, ref.query_idx)
        np.testing.assert_array_equal(got.db_idx, ref.db_idx)
        np.testing.assert_array_equal(got.ratio.view(np.int32), ref.ratio.view(np.int32))
    assert got.ratio.dtype == np.float32
    assert _events(q, db, cfg) == {(a, b) for a in ("new min", "second") for b in ("compatible", "incompatible")}


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_small_databases(nd, rng):
    q, _ = _clustered(rng, nq=12)
    db = _feats(nd, rng)
    if nd >= 2:
        db.xyz[1] = db.xyz[0] + 0.1  # a compatible pair
        db.scale[1] = db.scale[0]
        db.desc[1] = db.desc[0]  # and tied distances
    got = pairwise.ratio_match(q, db, device="cpu")
    want = jx_pairwise.ratio_match(_jx(q), _jx(db), JxConfig())
    assert len(got.db_idx) == len(want.db_idx) == (0 if nd < 2 else len(q))
    np.testing.assert_array_equal(got.db_idx, want.db_idx)
    np.testing.assert_array_equal(got.ratio, want.ratio)
    if nd >= 2:
        oracle = jx_pairwise._ratio_match_sequential_oracle(_jx(q), _jx(db), JxConfig())
        np.testing.assert_array_equal(got.db_idx, oracle.db_idx)
        np.testing.assert_array_equal(got.ratio, oracle.ratio)


def test_stacked_sets_equal_one_call_each(rng):
    """match_all_to_one's single launch over the concatenated query sets,
    split by offsets, equals a ratio_match per set (empty sets included)."""
    _, db = _clustered(rng)
    sets = [_clustered(rng, nq=n)[0] if n else FeatureSet.empty(0) for n in (17, 0, 40, 11)]
    stacked = pairwise.ratio_match_stacked(sets, db, device="cpu")
    for s, got in zip(sets, stacked):
        want = jx_pairwise.ratio_match(_jx(s), _jx(db), JxConfig())
        np.testing.assert_array_equal(got.query_idx, want.query_idx)
        np.testing.assert_array_equal(got.db_idx, want.db_idx)
        np.testing.assert_array_equal(got.ratio, want.ratio)
    assert [len(m.db_idx) for m in stacked] == [17, 0, 40, 11]


def test_compatibility_rounds_through_f64(rng):
    """The compatibility test's log is computed in f64 and rounded to f32
    (the kernel's (float)log((double)r)); its decisions equal numpy's f32
    ones away from the thresholds."""
    n = 4000
    xyz_a = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    xyz_b = (xyz_a + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    s_a = rng.uniform(2, 6, n).astype(np.float32)
    s_b = (s_a * np.exp(rng.normal(0, 0.4, n))).astype(np.float32)
    cfg = JxConfig()
    got = pairwise.compatible_features(
        *(torch.from_numpy(a) for a in (xyz_a, s_a, xyz_b, s_b)),
        float(np.float32(cfg.ratio_compat_log_scale)), cfg.ratio_compat_shift,
    ).numpy()
    want = jx_pairwise.compatible_features_arrays(xyz_a, s_a, None, xyz_b, s_b, None,
                                                  cfg.ratio_compat_log_scale, cfg.ratio_compat_shift)
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.8


def test_route_follows_the_data():
    """.key-like rows (integers 0..127, as uint8 holds them) take the int8
    route, float rows and a row holding 128 the f32 route; the int8
    wrapper refuses the others."""
    rng = np.random.default_rng(8)
    ranks = torch.from_numpy(rng.permuted(np.tile(np.arange(64, dtype=np.uint8), (30, 1)), axis=1).astype(np.float32))
    wide = torch.from_numpy(rng.integers(-128, 128, (30, 64)).astype(np.float32))
    floats = ranks + 0.25
    high = ranks.clone()
    high[7, 3] = 128.0
    assert knn_cuda.int8_route(ranks, ranks) and knn_cuda.int8_route(wide, ranks)
    xyz, scale = torch.zeros(30, 3), torch.ones(30)
    for q, db in ((floats, ranks), (ranks, floats), (high, ranks), (ranks, high)):
        assert not knn_cuda.int8_route(q, db)
        with pytest.raises(ValueError, match="int8 route"):
            pairwise.ratio_rows_int8(q, db, xyz, scale, 0.4, 0.5)
        want = pairwise.ratio_rows_plain(q, db, xyz, scale, 0.4, 0.5)
        for got in (pairwise.ratio_rows_f32(q, db, xyz, scale, 0.4, 0.5),
                    pairwise.ratio_rows(q, db, xyz, scale, 0.4, 0.5)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("nd", [2, 3, 127, 128, 129, 969])
def test_split_plain_equals_jax_on_tied_rows(nd):
    """Tie-heavy integer rows (a 3-letter alphabet, a third of the database
    repeated, row 1 a copy of row 0 when D <= 5, positions close enough that many events are compatible):
    ratio_rows_plain and ratio_rows_split_plain at the kernel's segment of
    16 rows and at 1, 5 and 64 equal the JAX ratio_match bit for bit."""
    rng = np.random.default_rng(nd)
    db = _feats(nd, rng, rng.integers(0, 3, (nd, 64)).astype(np.float32))
    k = max(1, nd // 3)
    db.desc[k : 2 * k] = db.desc[:k]
    db.xyz = rng.uniform(20, 24, (nd, 3)).astype(np.float32)
    q = _feats(120, rng, np.concatenate([db.desc[rng.integers(0, nd, 60)],
                                         rng.integers(0, 3, (60, 64)).astype(np.float32)]))
    cfg = JxConfig()
    want = jx_pairwise.ratio_match(_jx(q), _jx(db), cfg)
    args = [torch.from_numpy(a) for a in (q.desc, db.desc, db.xyz, db.scale)]
    args += [float(np.float32(cfg.ratio_compat_log_scale)), float(cfg.ratio_compat_shift)]
    got = [pairwise.ratio_rows_plain(*args)] + [pairwise.ratio_rows_split_plain(*args, seg) for seg in (16, 1, 5, 64)]
    d = jx_pairwise.dist_sqr_matrix(q.desc, db.desc)
    assert (np.sort(d, axis=1)[:, 1:] == np.sort(d, axis=1)[:, :-1]).mean() > 0.5  # ties
    for idx, ratio in got:
        np.testing.assert_array_equal(idx.numpy(), want.db_idx)
        np.testing.assert_array_equal(ratio.numpy().view(np.int32), want.ratio.view(np.int32))
