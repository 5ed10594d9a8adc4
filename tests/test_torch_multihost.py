"""PyTorch port: several processes (sift3d_torch.dist.multihost), two ranks
with gloo on the CPU.

Two processes of scripts/torch_multihost_worker.py join one process group
through a file:// store in tmp_path (no port to collide with other tests),
each with a local mesh of two CPU entries, on tests/multihost_worker.py's
32^3 blob volumes. Held against this process's single-process results, bit
for bit: every rank's gathered sets equal extract_features_many, the
rank-spanning group vote equals GroupMatcher on the CPU alone, the
rank-spanning sharded_knn equals knn_search, the rank-spanning sharded
solve equals solve_similarity; both ranks end identical, each extracts
its round-robin share, and a volume with two owners or none raises on
every rank. The subprocesses get 120 s; the run takes a few seconds.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sift3d_torch.match.groupvote import GroupMatcher
from sift3d_torch.match.knn import knn_search
from sift3d_torch.match.solve import solve_similarity
from sift3d_torch.pipeline.extract import extract_features_many

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "scripts" / "torch_multihost_worker.py"
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
WORLD = 2


def _blobs(seed, d=32):
    """tests/multihost_worker.py's volumes."""
    z, y, x = np.mgrid[0:d, 0:d, 0:d].astype(np.float32)
    r = np.random.default_rng(seed)
    vol = np.zeros((d, d, d), np.float32)
    for _ in range(8):
        bc = r.uniform(6, d - 6, 3)
        s = r.uniform(1.8, 3.5)
        a = r.uniform(60, 250)
        vol += a * np.exp(-(((z - bc[0]) ** 2 + (y - bc[1]) ** 2 + (x - bc[2]) ** 2) / (2 * s * s)))
    return vol


@pytest.fixture(scope="module")
def volumes():
    return [_blobs(s) for s in (1, 2, 3, 4, 5)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, volumes):
    """The two workers' outputs, rank 0 first."""
    tmp = tmp_path_factory.mktemp("multihost")
    np.save(tmp / "vols.npy", np.stack(volumes))
    init = f"file://{tmp / 'pg'}"
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), init, str(r), str(WORLD), str(tmp / "vols.npy"), str(outs[r]),
             "--device", "cpu", "--entries", "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=120)[0])
    finally:
        for pr in procs:
            pr.kill()
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def single(volumes):
    return extract_features_many(volumes, device="cpu")


def _sets(out):
    return [{k: out[f"set{i}_{k}"] for k in FIELDS} for i in range(int(out["n_sets"]))]


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_rank_extracts_its_share(ranks, volumes, rank):
    assert ranks[rank]["mine"].tolist() == list(range(rank, len(volumes), WORLD))


@pytest.mark.parametrize("rank", range(WORLD))
def test_gathered_sets_equal_single_process(ranks, single, rank):
    got = _sets(ranks[rank])
    assert len(got) == len(single) and sum(len(s) for s in single) > 0
    for g, want in zip(got, single):
        for k in FIELDS:
            a, b = g[k], getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_both_ranks_end_identical(ranks):
    a, b = ranks
    assert a.keys() == b.keys()
    own = ("rank", "mine", "extract_ms", "exchange_ms")  # each rank's own share and clock
    differ = [k for k in a if k not in own and not np.array_equal(a[k], b[k])]
    assert differ == []


def test_rank_spanning_group_vote_equals_single_process(ranks, single):
    want = GroupMatcher(single, device="cpu").match_all_to_all()
    for out in ranks:
        assert np.array_equal(out["votes"], want.votes)
        assert np.array_equal(out["counts"], want.counts)
        assert np.array_equal(out["log_likelihood"], want.log_likelihood)


def test_rank_spanning_knn_equals_single_process(ranks, single):
    db = np.concatenate([s.desc for s in single])
    dist, idx = knn_search(db, db, 5, device="cpu")
    for out in ranks:
        assert np.array_equal(out["knn_dist"], dist.numpy()) and np.array_equal(out["knn_idx"], idx.numpy())


def test_rank_spanning_solve_equals_single_process(ranks):
    for out in ranks:
        scale, rot, trans = solve_similarity(out["p"], out["q"], out["w"], device="cpu")
        assert float(out["scale"]) == scale
        assert np.array_equal(out["rot"], rot) and np.array_equal(out["trans"], trans)
        np.testing.assert_allclose(scale, 2.0, rtol=1e-4)


def test_ownership_must_be_unique(ranks):
    """Volume 0 claimed by both ranks, then by none: every rank raises."""
    for out in ranks:
        two, none = out["errors"].tolist()
        assert two.startswith("volume 0: expected exactly one owning process, got 2")
        assert none.startswith("volume 0: expected exactly one owning process, got 0")


def test_exchange_counts_its_bytes(ranks, single):
    assert int(ranks[0]["exchange_bytes"]) == sum(len(s) for s in single) * 84 * 4
