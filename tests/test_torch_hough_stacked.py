"""PyTorch port: the Hough vote over a stack of pairs (M3's segmented plain
versions), on the CPU.

- ``pairwise.match_keys_stacked`` over 5 query sets against one database
  (three similarity pairs with noise and outliers, one set of 3 features,
  so M <= 3, and one empty set) equals ``pairwise.match_keys`` on each
  pair alone and the JAX package's ``sift3d.match.pairwise.match_keys``,
  bit for bit: matches, inliers, their count and the transform (with
  --refine, whose solve sums in another order than the JAX package's, the
  transform against the per-pair call only).
- ``hough.hough_similarity_stacked`` equals ``hough_similarity`` per pair
  and the JAX ``hough_similarity``: the hypothesis index, rotation, scale,
  inliers and score.
- The segmented plain scorer equals ``hough_scores_plain`` on each pair
  alone; the segmented inlier mask equals ``hough_ok`` on each winner's row;
  ``hough.segment_blocks`` covers each pair's grid once.
- On a CUDA card (marker ``cuda``): both modes of the kernel on a stack
  with an empty segment, against the plain versions. JAX is imported only
  inside the tests that compare with it, so ``python -m pytest
  --noconftest -m cuda tests/test_torch_hough_stacked.py`` runs where JAX
  is missing.
"""

import numpy as np
import pytest
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.match import hough, pairwise

torch.set_num_threads(1)

THRESHOLDS = tuple(float(np.float32(t)) for t in (DEFAULT_CONFIG.hough_thres_scale, DEFAULT_CONFIG.hough_thres_trans,
                                                  DEFAULT_CONFIG.hough_thres_orien))


@pytest.fixture
def rng():
    return np.random.default_rng(2468)


def _rotation(rng):
    u, _, vt = np.linalg.svd(rng.standard_normal((3, 3)))
    r = u @ vt
    return r if np.linalg.det(r) > 0 else -r


def _database(rng, n):
    f = FeatureSet.empty(n)
    f.xyz = rng.uniform(20, 80, (n, 3)).astype(np.float32)
    f.scale = rng.uniform(2, 6, n).astype(np.float32)
    f.ori = np.stack([_rotation(rng) for _ in range(n)]).astype(np.float32)
    f.eigs = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    f.info[:] = INFO_FLAG_REORIENT
    f.desc = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (n, 1)), axis=1)
    return f


def _query(rng, f1, n, deg, s, t, noise=0.0, outliers=0):
    """n of f1's features moved by the inverse of a similarity (rotation
    about z by deg, scale s, shift t), with location and orientation noise,
    a few descriptor ranks swapped, and `outliers` relocated at random."""
    sel = rng.choice(len(f1), n, replace=False)
    th = np.deg2rad(deg)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    f2 = f1.select(sel)
    f2.xyz = (((f1.xyz[sel] - np.asarray(t)) @ rot) / s + rng.normal(0, noise, (n, 3))).astype(np.float32)
    f2.scale = (f1.scale[sel] / s).astype(np.float32)
    f2.ori = (np.einsum("ji,njk->nik", rot, f1.ori[sel].transpose(0, 2, 1)).transpose(0, 2, 1)
              + rng.normal(0, noise * 0.05, (n, 3, 3))).astype(np.float32)
    rows = np.arange(n)
    a, b = rng.integers(0, 64, (2, n))
    f2.desc[rows, a], f2.desc[rows, b] = f2.desc[rows, b], f2.desc[rows, a]
    if outliers:
        f2.xyz[:outliers] = rng.uniform(20, 80, (outliers, 3)).astype(np.float32)
    return f2


def _pairs(rng):
    f1 = _database(rng, 160)
    sets = [
        _query(rng, f1, 60, 12, 1.2, (5.0, 1.0, -2.0), noise=0.5, outliers=10),
        _query(rng, f1, 3, 0, 1.0, (0.0, 0.0, 0.0)),  # 3 matches: no vote
        _query(rng, f1, 120, -30, 0.8, (-6.0, 2.5, 9.0), noise=1.5, outliers=30),
        FeatureSet.empty(0),
        _query(rng, f1, 45, 25, 1.5, (4.0, -3.0, 2.0)),
    ]
    return f1, sets


def _jx(f):
    from sift3d.core.featureset import FeatureSet as JxFeatureSet

    return JxFeatureSet(xyz=f.xyz, scale=f.scale, ori=f.ori, eigs=f.eigs, info=f.info, desc=f.desc)


def _same_result(a, b, transform=True):
    np.testing.assert_array_equal(a.model_idx, b.model_idx)
    np.testing.assert_array_equal(a.input_idx, b.input_idx)
    np.testing.assert_array_equal(a.inlier, b.inlier)
    assert a.num_inliers == b.num_inliers
    if not transform:
        return
    assert a.transform.scale == b.transform.scale
    np.testing.assert_array_equal(a.transform.rot, b.transform.rot)
    np.testing.assert_array_equal(a.transform.trans, b.transform.trans)


@pytest.mark.parametrize("refine", [False, True])
def test_match_keys_stacked_equals_per_pair_and_jax(refine, rng):
    from sift3d.match import pairwise as jx_pairwise

    f1, sets = _pairs(rng)
    stacked = pairwise.match_keys_stacked(f1, sets, refine=refine, device="cpu")
    assert len(stacked) == len(sets)
    assert [len(r.model_idx) for r in stacked][1::2] == [3, 0]
    for f2, got in zip(sets, stacked):
        _same_result(got, pairwise.match_keys(f1, f2, refine=refine, device="cpu"))
        if len(f2):
            # the --refine solve's sums differ from the JAX package's in
            # order (a classified parity gap): with it only the vote is held
            _same_result(got, jx_pairwise.match_keys(_jx(f1), _jx(f2), refine=refine), transform=not refine)
    assert all(r.num_inliers > 20 for r in stacked[::2])


def _hough_pairs(rng):
    f1, sets = _pairs(rng)
    out = []
    for f2, rm in zip(sets, pairwise.ratio_match_stacked(sets, f1, device="cpu")):
        order = np.argsort(rm.ratio, kind="stable")
        mi, ii = rm.query_idx[order], rm.db_idx[order]
        if len(mi) > 3:
            out.append((f2.xyz[mi], f1.xyz[ii], f2.scale[mi], f1.scale[ii], f2.ori[mi], f1.ori[ii]))
    return out


def test_hough_similarity_stacked_equals_per_pair_and_jax(rng):
    from sift3d.core.config import SiftConfig as JxConfig
    from sift3d.match import hough as jx_hough

    pairs = _hough_pairs(rng)
    assert len(pairs) == 3
    for p, got in zip(pairs, hough.hough_similarity_stacked(pairs, device="cpu")):
        one = hough.hough_similarity(*p, device="cpu")
        jx = jx_hough.hough_similarity(*p, prob=np.ones(len(p[0]), np.float32), cfg=JxConfig())
        for want in (one, jx):
            assert got["hypothesis"] == want["hypothesis"]
            np.testing.assert_array_equal(got["rot"], np.asarray(want["rot"], np.float64))
            assert got["scale"] == float(want["scale"])
            np.testing.assert_array_equal(got["inliers"], np.asarray(want["inliers"]))
            assert got["score"] == float(want["score"]) == got["inliers"].sum()


def _stack(pairs):
    """The stacked hypotheses and matches of the pairs, and their offsets."""
    cat = [torch.from_numpy(np.concatenate([p[f] for p in pairs])) for f in range(6)]
    rots, scales = hough.hypotheses(*cat[2:])
    return (rots, scales, *cat), hough.segment_offsets([len(p[0]) for p in pairs])


def test_segmented_scores_equal_each_pair_alone(rng):
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    got = hough.hough_scores_plain(*args, THRESHOLDS, offsets)
    assert got.dtype == torch.int32 and got.shape == (offsets[-1],)
    for p, lo, hi in zip(pairs, offsets[:-1], offsets[1:]):
        one = [torch.from_numpy(a) for a in p]
        want = hough.hough_scores_plain(*hough.hypotheses(*one[2:]), *one, THRESHOLDS)
        assert torch.equal(got[lo:hi], want)
    # an empty segment in the stack changes nothing
    with_empty = np.insert(offsets, 2, offsets[1])
    assert torch.equal(hough.hough_scores_plain(*args, THRESHOLDS, with_empty), got)
    # the scores of the whole stack as one segment differ: the segments matter
    assert not torch.equal(hough.hough_scores_plain(*args, THRESHOLDS), got)


def test_segmented_inliers_are_hough_ok_on_each_winner(rng):
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    scores = hough.hough_scores_plain(*args, THRESHOLDS, offsets).numpy()
    winners = [lo + int(np.argmax(scores[lo:hi])) for lo, hi in zip(offsets[:-1], offsets[1:])]
    got = hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners)
    rots, scales, pts0, pts1, s0, s1, o0, o1 = args
    for w, lo, hi in zip(winners, offsets[:-1], offsets[1:]):
        want = hough.hough_ok(rots[w][None], scales[w][None], pts0[w][None], pts1[w][None], pts0[lo:hi],
                              pts1[lo:hi], s0[lo:hi], s1[lo:hi], o0[lo:hi], o1[lo:hi], THRESHOLDS)[0]
        assert torch.equal(got[lo:hi], want)
        assert int(want.sum()) == scores[w]  # the mask and the count agree


@pytest.mark.parametrize("sizes", [[1000] * 31, [3000, 0, 1, 128, 129, 257], [5]])
def test_segment_blocks_cover_each_pair_once(sizes):
    offsets = hough.segment_offsets(sizes)
    for inliers in (False, True):
        blocks = hough.segment_blocks(offsets, inliers)
        assert blocks.dtype == np.int32 and blocks[0] == 0 and len(blocks) == len(sizes) + 1
        for m, n in zip(sizes, np.diff(blocks)):
            tiles = -(-m // hough.HOUGH_THREADS)
            assert n == (tiles if inliers else tiles * -(-m // hough.HOUGH_CHUNK))
        # each block's pair, as the kernel's binary search finds it: the last
        # p with blocks[p] <= b
        pair = np.searchsorted(blocks, np.arange(blocks[-1]), side="right") - 1
        assert np.array_equal(np.bincount(pair, minlength=len(sizes)), np.diff(blocks))
    assert hough.segment_blocks(hough.segment_offsets([1000] * 31))[-1] == 31 * 8 * 8


@pytest.mark.cuda
def test_both_modes_on_the_card(rng):
    """One launch of each mode over a stack with an empty segment, against
    the segmented plain versions on the same CUDA tensors, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    args = tuple(a.to(dev).contiguous() for a in args)
    offsets = np.insert(offsets, 2, offsets[1])
    before = launches("sift3d_hough")
    scores = hough.hough_scores(*args, THRESHOLDS, offsets)
    torch.cuda.synchronize()
    assert launches("sift3d_hough") == before + 1
    assert torch.equal(scores, hough.hough_scores_plain(*args, THRESHOLDS, offsets))
    s = scores.cpu().numpy()
    winners = [lo + int(np.argmax(s[lo:hi])) if hi > lo else lo for lo, hi in zip(offsets[:-1], offsets[1:])]
    before = launches("sift3d_hough")
    mask = hough.hough_inliers(*args, THRESHOLDS, offsets, winners)
    torch.cuda.synchronize()
    assert launches("sift3d_hough") == before + 1
    assert torch.equal(mask, hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners))
