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
- M3's wrappers take the matches alone and form the hypotheses themselves:
  on stacks with rows that hit every guard of ``hough.hypotheses``
  (coincident virtual points, collinear ori rows, s0 = 0, a NaN ori row),
  the plain ``hough_scores`` and ``hough_inliers`` equal ``hough_ok``
  composed with ``hough.hypotheses``, the winners' rotations and scales
  bit for bit; the inlier output is one buffer (one copy to the host); the
  plain route counts no ``card_hypotheses``.
- On a CUDA card (marker ``cuda``): both modes of the kernel on a stack
  with an empty segment, against the plain versions; the guard rows as
  single-row pairs (each its pair's winner) against the plain versions;
  ``hough_similarity_stacked`` on the card against the CPU call, dict for
  dict (rotation and scale as int32 views), on 31 pairs of 969 matches, on
  single pairs of M in {1, 4, 127, 128, 129} and on the guard stack, with
  ``card_hypotheses`` counting M. JAX is imported only inside the tests
  that compare with it, so ``python -m pytest --noconftest -m cuda
  tests/test_torch_hough_stacked.py`` runs where JAX is missing.
"""

import numpy as np
import pytest
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.match import hough, pairwise
from sift3d_torch.utils.timing import TRACER

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
    """The stacked matches of the pairs, and their offsets."""
    cat = [torch.from_numpy(np.concatenate([p[f] for p in pairs])) for f in range(6)]
    return cat, hough.segment_offsets([len(p[0]) for p in pairs])


def test_segmented_scores_equal_each_pair_alone(rng):
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    got = hough.hough_scores_plain(*args, THRESHOLDS, offsets)
    assert got.dtype == torch.int32 and got.shape == (offsets[-1],)
    for p, lo, hi in zip(pairs, offsets[:-1], offsets[1:]):
        one = [torch.from_numpy(a) for a in p]
        want = hough.hough_scores_plain(*one, THRESHOLDS)
        assert torch.equal(got[lo:hi], want)
    # an empty segment in the stack changes nothing
    with_empty = np.insert(offsets, 2, offsets[1])
    assert torch.equal(hough.hough_scores_plain(*args, THRESHOLDS, with_empty), got)
    # the scores of the whole stack as one segment differ: the segments matter
    assert not torch.equal(hough.hough_scores_plain(*args, THRESHOLDS), got)


def _first_maxima(scores, offsets):
    """Each segment's first best row (its first row if it is empty)."""
    s = np.asarray(scores)
    return [lo + int(np.argmax(s[lo:hi])) if hi > lo else lo for lo, hi in zip(offsets[:-1], offsets[1:])]


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


def _same_up_to_nan_payload(a, b):
    """Bit-equal where a holds a number; NaN where a holds a NaN (a NaN's
    sign and payload follow the arithmetic that carried it: the card returns
    its canonical NaN, the host's vector and scalar loops differ)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(_bits(np.where(nan, 0, a)), _bits(np.where(nan, 0, b)))


def _rot_scale(rots, scales, w):
    """Row w's hypothesis as M3's inlier output holds it: 9 + 1 floats."""
    return torch.cat([rots[w].reshape(9), scales[w][None]])


def test_segmented_inliers_are_hough_ok_on_each_winner(rng):
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    scores = hough.hough_scores_plain(*args, THRESHOLDS, offsets).numpy()
    winners = _first_maxima(scores, offsets)
    got, rs = hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners)
    assert got.dtype == torch.bool and rs.dtype == torch.float32 and rs.shape == (len(pairs), 10)
    pts0, pts1, s0, s1, o0, o1 = args
    rots, scales = hough.hypotheses(s0, s1, o0, o1)
    for p, (w, lo, hi) in enumerate(zip(winners, offsets[:-1], offsets[1:])):
        want = hough.hough_ok(rots[w][None], scales[w][None], pts0[w][None], pts1[w][None], pts0[lo:hi],
                              pts1[lo:hi], s0[lo:hi], s1[lo:hi], o0[lo:hi], o1[lo:hi], THRESHOLDS)[0]
        assert torch.equal(got[lo:hi], want)
        assert int(want.sum()) == scores[w]  # the mask and the count agree
        np.testing.assert_array_equal(_bits(rs[p]), _bits(_rot_scale(rots, scales, w)))


def _similarity_rows(rng, m):
    """m putative matches (pts0, pts1, s0, s1, o0, o1) of a similarity
    (scale 1.1, a random rotation, a shift) with location and orientation
    noise and a third of them relocated at random."""
    rot = _rotation(rng)
    o0 = np.array([_rotation(rng) for _ in range(m)]).reshape(m, 3, 3)
    p0 = rng.uniform(20, 160, (m, 3))
    s0 = rng.uniform(1.5, 8.0, m)
    p1 = 1.1 * p0 @ rot.T + np.array([3.0, -2.0, 5.0]) + rng.normal(0, 1.0, (m, 3))
    p1[: m // 3] = rng.uniform(20, 160, (m // 3, 3))
    o1 = np.einsum("ij,njk->nik", rot, o0.transpose(0, 2, 1)).transpose(0, 2, 1) + rng.normal(0, 0.1, (m, 3, 3))
    s1 = 1.1 * s0 * np.exp(rng.normal(0, 0.2, m))
    return [np.ascontiguousarray(a, np.float32) for a in (p0, p1, s0, s1, o0, o1)]


# ori rows that hit hough.hypotheses' guards: three coincident virtual
# points (zero-length edges, every norm 0), collinear rows along an axis
# (an exactly zero cross product), and a NaN
_ROW0 = np.array([0.5, -0.25, 1.0])
GUARD_ORI = {
    "coincident": np.stack([_ROW0] * 3),
    "collinear": np.stack([_ROW0, _ROW0 + [0.0, 2.0, 0.0], _ROW0 + [0.0, -4.0, 0.0]]),
    "nan": np.stack([_ROW0, _ROW0 + [1.0, 0.0, 0.0], [np.nan, 0.0, 1.0]]),
}
GUARDS = ("coincident", "collinear", "s0_zero", "nan")


def _plant(rows, k, guard):
    """Make row k of the matches hit `guard`, on the o0 side (the s0 floor:
    s0 = 0) and, for the ori guards, on the o1 side too."""
    if guard == "s0_zero":
        rows[2][k] = 0.0
        return
    rows[4][k] = GUARD_ORI[guard]
    rows[5][k] = GUARD_ORI[guard][::-1]


def _guard_pairs(rng, sizes, single=GUARDS):
    """Similarity pairs of the given sizes, each of 5 or more with the
    guards planted in rows 1-4 (never a winner: a clean row scores more),
    then one single-row pair for each guard in `single` (its own winner)."""
    pairs = []
    for m in sizes:
        rows = _similarity_rows(rng, m)
        if m >= 5:
            for k, guard in enumerate(GUARDS, start=1):
                _plant(rows, k, guard)
        pairs.append(rows)
    for guard in single:
        rows = _similarity_rows(rng, 1)
        _plant(rows, 0, guard)
        pairs.append(rows)
    return pairs


@pytest.mark.parametrize("sizes", [[1], [4], [127], [128, 129], [60, 0, 45]])
def test_plain_wrappers_are_hough_ok_on_the_hypotheses(sizes, rng):
    """The wrappers on CPU tensors (the plain route) take the matches alone:
    the scores equal hough_ok summed over each segment's hypotheses from
    hough.hypotheses, the masks hough_ok on each winner's row, and the
    winners' rotations and scales are hough.hypotheses' bits (zeros for an
    empty segment)."""
    pairs = _guard_pairs(rng, sizes)
    args, offsets = _stack(pairs)
    pts0, pts1, s0, s1, o0, o1 = args
    rots, scales = hough.hypotheses(s0, s1, o0, o1)
    assert torch.isnan(rots).any() and (scales > 1e15).any()  # the guards were reached
    scores = hough.hough_scores(*args, THRESHOLDS, offsets)
    winners = _first_maxima(scores, offsets)
    mask, rs = hough.hough_inliers(*args, THRESHOLDS, offsets, winners)
    for p, (w, lo, hi) in enumerate(zip(winners, offsets[:-1], offsets[1:])):
        seg = [a[lo:hi] for a in args]
        want = hough.hough_ok(rots[lo:hi], scales[lo:hi], *seg[:2], *seg, THRESHOLDS).sum(dim=1, dtype=torch.int32)
        assert torch.equal(scores[lo:hi], want)
        if hi == lo:
            assert not rs[p].any()
            continue
        one = slice(w, w + 1)
        ok = hough.hough_ok(rots[one], scales[one], pts0[one], pts1[one], *seg, THRESHOLDS)[0]
        assert torch.equal(mask[lo:hi], ok)
        _same_up_to_nan_payload(rs[p], _rot_scale(rots, scales, w))
    # the single-row guard pairs win with their own degenerate hypotheses
    assert winners[-len(GUARDS):] == list(offsets[-len(GUARDS) - 1 : -1])


@pytest.mark.parametrize("m", [1, 4, 127, 128, 129])
def test_inlier_output_is_one_buffer(m, rng):
    """M3's inlier output is one uint8 buffer, the mask then the winners'
    rotations and scales at a float-aligned offset, so one copy brings both
    to the host; its views are hough_inliers_plain's outputs."""
    pairs = _guard_pairs(rng, [m, 3], single=())
    args, offsets = _stack(pairs)
    winners = _first_maxima(hough.hough_scores(*args, THRESHOLDS, offsets), offsets)
    packed = hough._inliers_packed(*args, THRESHOLDS, offsets, winners)
    assert packed.dtype == torch.uint8 and packed.numel() == -(-(m + 3) // 4) * 4 + 40 * len(pairs)
    mask, rs = hough._unpack_inliers(packed, m + 3, len(pairs))
    assert mask.data_ptr() == packed.data_ptr() and rs.data_ptr() % 4 == 0
    want_mask, want_rs = hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners)
    assert torch.equal(mask, want_mask)
    _same_up_to_nan_payload(rs, want_rs)


def test_plain_route_forms_no_card_hypotheses(rng):
    pairs = _guard_pairs(rng, [40, 7])
    with TRACER.record():
        hough.hough_similarity_stacked(pairs, device="cpu")
    assert TRACER.counts.get("card_hypotheses", 0) == 0


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_both_modes_on_the_card(rng):
    """One launch of each mode over a stack with an empty segment, against
    the segmented plain versions on the same CUDA tensors, exactly."""
    dev = _card()
    pairs = _hough_pairs(rng)
    args, offsets = _stack(pairs)
    args = tuple(a.to(dev).contiguous() for a in args)
    offsets = np.insert(offsets, 2, offsets[1])
    before = launches("sift3d_hough")
    scores = hough.hough_scores(*args, THRESHOLDS, offsets)
    torch.cuda.synchronize()
    assert launches("sift3d_hough") == before + 1
    assert torch.equal(scores, hough.hough_scores_plain(*args, THRESHOLDS, offsets))
    winners = _first_maxima(scores.cpu(), offsets)
    before = launches("sift3d_hough")
    mask, rs = hough.hough_inliers(*args, THRESHOLDS, offsets, winners)
    torch.cuda.synchronize()
    assert launches("sift3d_hough") == before + 1
    want_mask, want_rs = hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners)
    assert torch.equal(mask, want_mask)
    np.testing.assert_array_equal(_bits(rs.cpu()), _bits(want_rs.cpu()))


@pytest.mark.cuda
def test_guard_rows_on_the_card(rng):
    """Each guard row as a pair of its own, so it is its pair's winner, and
    planted among similarity pairs: the card's scores and masks equal the
    plain versions', and the winners' rotations and scales their bits (a
    NaN as a NaN)."""
    dev = _card()
    pairs = _guard_pairs(rng, [60, 5, 129])
    args, offsets = _stack(pairs)
    scores = hough.hough_scores(*(a.to(dev).contiguous() for a in args), THRESHOLDS, offsets).cpu()
    assert torch.equal(scores, hough.hough_scores_plain(*args, THRESHOLDS, offsets))
    winners = _first_maxima(scores, offsets)
    mask, rs = hough.hough_inliers(*(a.to(dev).contiguous() for a in args), THRESHOLDS, offsets, winners)
    want_mask, want_rs = hough.hough_inliers_plain(*args, THRESHOLDS, offsets, winners)
    assert torch.equal(mask.cpu(), want_mask)
    assert torch.isnan(want_rs[-1]).any()  # the NaN row won its own pair
    _same_up_to_nan_payload(rs.cpu(), want_rs)


STACKS = {
    "31 pairs of 969": lambda rng: [_similarity_rows(rng, 969) for _ in range(31)],
    **{f"M={m}": (lambda m: lambda rng: [_similarity_rows(rng, m)])(m) for m in (1, 4, 127, 128, 129)},
    # every guard among the rows of larger pairs, and the ori guards as
    # single-row pairs: their own winners (not the NaN row, whose payload
    # the card does not keep)
    "guards": lambda rng: _guard_pairs(rng, [200, 64, 5], single=("coincident", "collinear", "s0_zero")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_stacked_vote_on_the_card_equals_the_cpu(stack, rng):
    """hough_similarity_stacked on the card against the CPU call, dict for
    dict: the hypothesis, the rotation and scale as int32 views, the
    inliers and the score; the card formed card_hypotheses = M hypotheses
    in two launches."""
    dev = _card()
    pairs = STACKS[stack](rng)
    before = launches("sift3d_hough")
    with TRACER.record():
        got = hough.hough_similarity_stacked(pairs, device=dev)
    assert launches("sift3d_hough") == before + 2
    assert TRACER.counts["card_hypotheses"] == sum(len(p[0]) for p in pairs)
    want = hough.hough_similarity_stacked(pairs, device="cpu")
    assert len(got) == len(want) == len(pairs)
    for g, w in zip(got, want):
        assert g["hypothesis"] == w["hypothesis"]
        assert g["rot"].dtype == np.float64
        np.testing.assert_array_equal(_bits(g["rot"]), _bits(w["rot"]))
        np.testing.assert_array_equal(_bits(g["scale"]), _bits(w["scale"]))
        np.testing.assert_array_equal(g["inliers"], w["inliers"])
        assert g["score"] == w["score"]
    if stack == "31 pairs of 969":
        assert all(g["score"] > 100 for g in got)
