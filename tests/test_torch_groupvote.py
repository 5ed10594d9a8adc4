"""PyTorch port: the group soft vote against the JAX package.

``groupvote.GroupMatcher`` on the CPU (M1's plain version for the kNN, the
vote in f64) against ``sift3d.match.groupvote.GroupMatcher``:
- ``_vote_all`` on the same kNN rows, with mixed query images and labels;
- ``match_all_to_all`` end to end, with labels, with -g geometry columns
  (dyadic geometry, whose distances are exact, and generic floats), with
  exact duplicates across images (zero distances: the d_min fallback) and
  with empty sets;
- the port's own line-by-line oracle ``_search_image_loop``.
Counts equal exactly; votes and log-likelihoods within 1e-12 relative (the
port sums segments in ``tree_sum``'s order, numpy in ``np.add.at``'s).
"""

import numpy as np
import pytest
import torch

from sift3d.core.featureset import FeatureSet as JxFeatureSet
from sift3d.match import groupvote as jx_groupvote
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.core.numerics import numpy_sum, tree_sum
from sift3d_torch.match import groupvote

torch.set_num_threads(1)


def _feats(n, rng, desc=None, dyadic=False):
    f = FeatureSet.empty(n)
    if dyadic:  # integer locations, power-of-two scales: -g columns exact
        f.xyz = rng.integers(10, 60, (n, 3)).astype(np.float32)
        f.scale = (2.0 ** rng.integers(1, 3, n)).astype(np.float32)
    else:
        f.xyz = rng.uniform(20, 80, (n, 3)).astype(np.float32)
        f.scale = rng.uniform(2, 6, (n,)).astype(np.float32)
    f.info[:] = INFO_FLAG_REORIENT
    f.desc = desc if desc is not None else rng.permuted(np.tile(np.arange(64.0, dtype=np.float32), (n, 1)), axis=1)
    return f


def _jx(f):
    return JxFeatureSet(xyz=f.xyz, scale=f.scale, ori=f.ori, eigs=f.eigs, info=f.info, desc=f.desc)


def _swap(desc, rng, k=3):
    out = desc.copy()
    for _ in range(k):
        a, b = rng.integers(0, 64, 2)
        out[..., [a, b]] = out[..., [b, a]]
    return out


def _sets(rng, sizes, dyadic=False):
    sets = [_feats(n, rng, dyadic=dyadic) for n in sizes]
    # cross-image similarity: near-copies and exact duplicates
    sets[1].desc[:6] = _swap(sets[0].desc[:6], rng)
    sets[2].desc[:4] = sets[0].desc[:4]
    sets[-1].desc[:5] = _swap(sets[1].desc[:5], rng, 1)
    return sets


def _close(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.votes, want.votes, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-12, atol=0)


CELLS = {
    "plain": dict(sizes=(14, 17, 12, 15), labels=None, weight=-1.0),
    "labels": dict(sizes=(12, 13, 14, 15, 16), labels=[0, 1, 1, 2, 0], weight=-1.0),
    "-g dyadic": dict(sizes=(14, 17, 12, 15), labels=None, weight=0.5, dyadic=True),
    "-g float": dict(sizes=(14, 17, 12, 15), labels=[1, 0, 1, 0], weight=0.5),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_match_all_to_all_equals_jax(cell, rng):
    c = CELLS[cell]
    sets = _sets(rng, c["sizes"], c.get("dyadic", False))
    want = jx_groupvote.GroupMatcher([_jx(s) for s in sets], c["labels"], c["weight"]).match_all_to_all()
    gm = groupvote.GroupMatcher(sets, c["labels"], c["weight"], device="cpu")
    got = gm.match_all_to_all()
    _close(got, want)
    assert got.counts.sum() > 0 and (got.votes > 0).sum() > 2
    for i in range(len(sets)):  # the port's own line-by-line oracle
        one = gm._search_image_loop(i)
        np.testing.assert_array_equal(got.counts[i], one.counts[0])
        np.testing.assert_allclose(got.votes[i], one.votes[0], rtol=1e-12)
        np.testing.assert_allclose(got.log_likelihood[i], one.log_likelihood[0], rtol=1e-12)


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_vote_all_equals_jax_on_the_same_knn_rows(k, rng):
    """Mixed query images in shuffled order, so segments are not contiguous."""
    sets = _sets(rng, (11, 9, 13, 10))
    labels = [2, 0, 1, 0]
    jm = jx_groupvote.GroupMatcher([_jx(s) for s in sets], labels)
    gm = groupvote.GroupMatcher(sets, labels, device="cpu")
    dist, idx = gm.knn(k)
    perm = rng.permutation(len(gm.feat_img))[:30]
    dist, idx, q_img = dist[perm].double(), idx[perm], torch.from_numpy(gm.feat_img[perm])
    want = jm._vote_all(dist.numpy(), idx.numpy(), q_img.numpy())
    got = gm._vote_all(dist, idx, q_img)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-12, atol=0)


def test_empty_sets(rng):
    sets = [FeatureSet.empty(0), _feats(5, rng), FeatureSet.empty(0)]
    got = groupvote.GroupMatcher(sets, device="cpu").match_all_to_all()
    want = jx_groupvote.GroupMatcher([_jx(s) for s in sets]).match_all_to_all()
    assert got.votes.shape == (3, 3) and got.counts.sum() == 0
    _close(got, want)
    none = groupvote.GroupMatcher([FeatureSet.empty(0)] * 2, device="cpu").match_all_to_all()
    assert none.votes.sum() == 0 and none.counts.dtype == np.int64


def test_vote_files_equal_jax(tmp_path, rng):
    sets = _sets(rng, (10, 12, 9))
    res = groupvote.GroupMatcher(sets, device="cpu").match_all_to_all()
    jres = jx_groupvote.GroupMatcher([_jx(s) for s in sets]).match_all_to_all()
    for who, r, write in (("port", res, groupvote.write_vote_files), ("jax", jres, jx_groupvote.write_vote_files)):
        write(r, str(tmp_path / f"{who}_votes.txt"), str(tmp_path / f"{who}_counts.txt"), tag="Peaks")
        write(r, str(tmp_path / f"{who}_votes.txt"), str(tmp_path / f"{who}_counts.txt"), tag="Valley", append=True)
    for name in ("votes", "counts"):
        assert (tmp_path / f"port_{name}.txt").read_bytes() == (tmp_path / f"jax_{name}.txt").read_bytes()


def test_sums_orders():
    """numpy_sum is numpy's row sum bit for bit; segment_sum is tree_sum
    over each segment's members in order, zero-padded."""
    rng = np.random.default_rng(0)
    for n in (3, 5, 8, 13, 64, 129, 300):
        a = rng.standard_normal((50, n)) * np.exp(rng.standard_normal((50, n)) * 4)
        assert np.array_equal(numpy_sum(torch.from_numpy(a)).numpy(), a.sum(axis=1))
    vals = torch.from_numpy(rng.standard_normal((40, 3)))
    seg = torch.from_numpy(rng.integers(0, 6, 40))
    got = groupvote.segment_sum(vals, seg, 7)
    for s in range(7):
        members = vals[seg == s]
        want = tree_sum(members.T) if len(members) else torch.zeros(3, dtype=vals.dtype)
        assert torch.equal(got[s], want)
