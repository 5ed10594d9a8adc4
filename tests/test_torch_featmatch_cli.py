"""PyTorch port: the featmatch CLI against the JAX CLI, on the CPU
(``main(argv, device="cpu")``).

The fixtures are tests/test_cli.py:52-87's blob volumes (a 40^3 volume
with two Gaussian blobs, rolled by 2 voxels along x) plus a third rolled
by -1 along y, extracted to .key files by the port's featextract. Each CLI
runs in its own directory on copies of the keys under the same relative
names (the per-pair outputs go next to the key paths), and every output
file must be byte-identical, for each flag set below. With --refine the
JAX package solves in f32 and its translations drift from an f64 replay of
the same fit (about 1.5e-4 voxel here); the port's equal that replay, so
the transforms are compared there: scale and rotation within 1e-5 of the
JAX CLI's, translations within 1e-9 of the replay and no farther from the
JAX CLI's than the JAX CLI is from the replay.

--shard-match (the group vote's kNN sharded over main(..., mesh=["cpu"] *
8)): every output file the same bytes as the same call without the flag,
and as the JAX CLI's --shard-match on its 8 simulated devices, except with
-g, where the JAX CLI's sharded votes leave its own unsharded ones (a
witness test; the port's equal the unsharded JAX CLI's). Without
--all-to-all both CLIs print the same warning.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from sift3d.cli import featmatch as jx_cli
from sift3d_torch.cli import featextract as tx_extract
from sift3d_torch.cli import featmatch as tx_cli
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.match.register import SimilarityTransform

torch.set_num_threads(1)

NAMES = ("a.key", "b.key", "c.key")
FLAG_SETS = {
    "default": [],
    "all-to-all": ["--all-to-all"],
    "s0": ["-s0"],
    "s1": ["-s1"],
    "s2 all-to-all": ["-s2", "--all-to-all"],
    "r-": ["-r-"],
    "n3": ["-n", "3", "--all-to-all"],
    "f list": ["-f", "list.txt", "--all-to-all"],
    "g0.5 all-to-all": ["-g", "0.5", "--all-to-all"],
}


def _blob(dims=40, s=3.0, c=(20, 20, 20)):
    z, y, x = np.mgrid[0:dims, 0:dims, 0:dims].astype(np.float32)
    return np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s))).astype(np.float32)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys")
    v1 = _blob(c=(20, 20, 20)) * 200 + _blob(c=(12, 26, 14), s=2.5) * 150
    for name, vol in zip(NAMES, (v1, np.roll(v1, 2, axis=2), np.roll(v1, -1, axis=1))):
        nifti.write(str(d / "v.nii"), vol)
        with contextlib.redirect_stdout(io.StringIO()):
            assert tx_extract.main([str(d / "v.nii"), str(d / name)], device="cpu") == 0
    return d


def _run_both(argv, keys, tmp_path, monkeypatch):
    """Run the JAX CLI and the port's (on the CPU), each in its own
    directory holding copies of the keys; returns the two directories."""
    out = {}
    for who, run in (("jax", jx_cli.main), ("port", lambda a: tx_cli.main(a, device="cpu"))):
        out[who] = tmp_path / who
        out[who].mkdir()
        for name in NAMES:
            shutil.copy(keys / name, out[who] / name)
        (out[who] / "list.txt").write_text("\n".join(NAMES) + "\n")
        monkeypatch.chdir(out[who])
        with contextlib.redirect_stdout(io.StringIO()):
            assert run(argv) == 0, who
    return out["jax"], out["port"]


def _outputs(d):
    return sorted(f for f in os.listdir(d) if f not in NAMES and f != "list.txt")


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_outputs_byte_identical_to_jax(flags, keys, tmp_path, monkeypatch):
    argv = FLAG_SETS[flags] + ([] if "-f" in FLAG_SETS[flags] else list(NAMES))
    jax_dir, port_dir = _run_both(argv, keys, tmp_path, monkeypatch)
    files = _outputs(jax_dir)
    assert files == _outputs(port_dir)
    assert {"report.txt", "b.key.trans.txt", "c.key.matches.img2.txt", "c.key.update.key"} <= set(files)
    if "--all-to-all" in argv:
        assert {"matching_votes.txt", "vote_count.txt", "report.all.txt"} <= set(files)
    differ = [f for f in files if (jax_dir / f).read_bytes() != (port_dir / f).read_bytes()]
    assert differ == []
    with open(port_dir / "b.key.matches.img1.txt") as f:
        n_matches = int(f.readlines()[2].split(":")[1])
    if flags in ("default", "all-to-all"):
        assert n_matches > 0  # the pair registered: test_cli.py's shift of (-2, 0, 0)
        ts = SimilarityTransform.read_matrix(str(port_dir / "b.key.trans.txt"))
        np.testing.assert_allclose(ts.trans, [-2, 0, 0], atol=1.0)


def _replay(keys_dir, pair):
    """f64 replay of the refined fit of `pair` (the inliers from the
    port's own inlier list, the same as the JAX CLI's)."""
    f1 = keyfile.read_text(str(keys_dir / "a.key"), eig_threshold=140.0)[0].remove_non_reoriented()
    f2 = keyfile.read_text(str(keys_dir / pair), eig_threshold=140.0)[0].remove_non_reoriented()
    def feat_column(name):  # img1.txt lists each match's image-2 row, img2.txt its image-1 row
        rows = [ln.split("\t") for ln in open(keys_dir / name) if not ln.startswith("#")]
        return [int(r[5].split("feat")[1]) for r in rows]

    idx2 = feat_column(f"{pair}.matches.img1.txt")
    idx1 = feat_column(f"{pair}.matches.img2.txt")
    p = f2.xyz[idx2].astype(np.float64)
    q = f1.xyz[idx1].astype(np.float64)
    pb, qb = p.mean(0), q.mean(0)
    cov = (q[:, :, None] * p[:, None, :]).mean(0) - np.outer(qb, pb)
    u, s, vt = np.linalg.svd(cov)
    dg = np.array([1.0, 1.0, np.sign(np.linalg.det(u) * np.linalg.det(vt))])
    rot = (u * dg) @ vt
    scale = (s * dg).sum() / ((p * p).sum(1).mean() - pb @ pb)
    return scale, rot, qb - scale * rot @ pb


def test_refine_transforms(keys, tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(["--refine", *NAMES], keys, tmp_path, monkeypatch)
    assert _outputs(jax_dir) == _outputs(port_dir)
    for pair in NAMES[1:]:
        for f in (f"{pair}.matches.img1.txt", f"{pair}.matches.img2.txt", f"{pair}.update.key"):
            assert (jax_dir / f).read_bytes() == (port_dir / f).read_bytes(), f
        want = SimilarityTransform.read_matrix(str(jax_dir / f"{pair}.trans.txt"))
        got = SimilarityTransform.read_matrix(str(port_dir / f"{pair}.trans.txt"))
        scale, rot, trans = _replay(port_dir, pair)
        np.testing.assert_allclose(got.scale, want.scale, rtol=1e-5)
        np.testing.assert_allclose(got.rot, want.rot, atol=1e-5)
        # printed to six decimals: the port's file is the replay, rounded
        np.testing.assert_allclose(got.trans, trans, atol=1e-6)
        assert np.abs(got.trans - want.trans).max() <= np.abs(want.trans - trans).max() + 1e-6
        np.testing.assert_allclose(got.trans, want.trans, atol=5e-4)


SHARD_FLAG_SETS = {
    "all-to-all": ["--all-to-all"],
    "s2 all-to-all": ["-s2", "--all-to-all"],
    "n3": ["-n", "3", "--all-to-all"],
    "g0.5 all-to-all": ["-g", "0.5", "--all-to-all"],
}
SHARD_MESH = ["cpu"] * 8  # the JAX tests' 8 simulated devices


def _run(run, argv, keys, d, monkeypatch):
    """run(argv) in directory d on copies of the keys; returns its stdout."""
    d.mkdir()
    for name in NAMES:
        shutil.copy(keys / name, d / name)
    monkeypatch.chdir(d)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(argv) == 0
    return out.getvalue()


def _differ(a, b):
    files = _outputs(a)
    assert files == _outputs(b)
    return [f for f in files if f != "_command.txt" and (a / f).read_bytes() != (b / f).read_bytes()]


@pytest.mark.parametrize("flags", sorted(SHARD_FLAG_SETS))
def test_shard_match_equals_unsharded(flags, keys, tmp_path, monkeypatch):
    """--shard-match over 8 CPU entries: every output file the same bytes
    as the same call without it (_command.txt records the flag)."""
    argv = SHARD_FLAG_SETS[flags] + list(NAMES)
    plain = tmp_path / "plain"
    _run(lambda a: tx_cli.main(a, device="cpu"), argv, keys, plain, monkeypatch)
    sharded = tmp_path / "sharded"
    _run(lambda a: tx_cli.main(a, device="cpu", mesh=SHARD_MESH), ["--shard-match", *argv], keys, sharded,
         monkeypatch)
    assert {"matching_votes.txt", "vote_count.txt"} <= set(_outputs(sharded))
    assert _differ(plain, sharded) == []


@pytest.mark.parametrize("flags", ["all-to-all", "s2 all-to-all", "n3"])
def test_shard_match_byte_identical_to_jax(flags, keys, tmp_path, monkeypatch):
    argv = ["--shard-match", *SHARD_FLAG_SETS[flags], *NAMES]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    _run(jx_cli.main, argv, keys, jax_dir, monkeypatch)
    _run(lambda a: tx_cli.main(a, device="cpu", mesh=SHARD_MESH), argv, keys, port_dir, monkeypatch)
    assert _differ(jax_dir, port_dir) == []
    assert (jax_dir / "_command.txt").read_bytes() == (port_dir / "_command.txt").read_bytes()


def test_jax_shard_match_moves_the_g_votes(keys, tmp_path, monkeypatch):
    """Witness (ROADMAP Queue 3): with -g the JAX CLI's --shard-match votes
    differ from its own unsharded votes. Its sharded kNN computes the
    67-column distances in another order than its knn_search, so distances
    of rows whose descriptors tie (their geometry columns alone apart)
    cancel to other ulps of the norms, and near-tied neighbours swap. The
    port's --shard-match -g equals the JAX CLI without the flag instead."""
    argv = ["-g", "0.5", "--all-to-all", *NAMES]
    dirs = {}
    for who, run, extra in (("jax", jx_cli.main, []), ("jax_shard", jx_cli.main, ["--shard-match"]),
                            ("port_shard", lambda a: tx_cli.main(a, device="cpu", mesh=SHARD_MESH),
                             ["--shard-match"])):
        dirs[who] = tmp_path / who
        _run(run, extra + argv, keys, dirs[who], monkeypatch)
    assert sorted(_differ(dirs["jax"], dirs["jax_shard"])) == ["matching_votes.txt", "vote_count.txt"]
    assert _differ(dirs["jax"], dirs["port_shard"]) == []


def test_shard_match_without_all_to_all_warns(keys, tmp_path, monkeypatch):
    argv = ["--shard-match", *NAMES]
    said = _run(lambda a: tx_cli.main(a, device="cpu", mesh=SHARD_MESH), argv, keys, tmp_path / "port",
                monkeypatch)
    jax_said = _run(jx_cli.main, argv, keys, tmp_path / "jax", monkeypatch)
    warning = ("Warning: --shard-match only affects --all-to-all group matching; pairwise matching runs "
               "unsharded.\n")
    assert said.startswith(warning) and jax_said.startswith(warning)
    assert "matching_votes.txt" not in _outputs(tmp_path / "port")
    assert _differ(tmp_path / "jax", tmp_path / "port") == []


def test_entry_points_need_a_card_by_default(keys, tmp_path, monkeypatch):
    """device=None means the card: without one every entry point raises."""
    from sift3d_torch import extract_features_batch
    from sift3d_torch.dist import gather, multihost, solve
    from sift3d_torch.match import groupvote, hough, knn, pairwise

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    feats = keyfile.read_text(str(keys / "a.key"))[0]
    calls = {
        "knn_search": lambda: knn.knn_search(feats.desc, feats.desc, 3),
        "ratio_match": lambda: pairwise.ratio_match(feats, feats),
        "match_keys": lambda: pairwise.match_keys(feats, feats),
        "hough_similarity": lambda: hough.hough_similarity(feats.xyz, feats.xyz, feats.scale, feats.scale,
                                                           feats.ori, feats.ori),
        "GroupMatcher": lambda: groupvote.GroupMatcher([feats, feats]),
        "featmatch.main": lambda: tx_cli.main([str(keys / n) for n in NAMES]),
        "featmatch.main --shard-match": lambda: tx_cli.main(
            ["--all-to-all", "--shard-match", *(str(keys / n) for n in NAMES)]),
        "sharded_knn": lambda: gather.sharded_knn(feats.desc, feats.desc, 3),
        "gather_keypoint_sets": lambda: gather.gather_keypoint_sets([torch.from_numpy(feats.desc)[None]]),
        "solve_similarity_sharded": lambda: solve.solve_similarity_sharded(feats.xyz, feats.xyz, feats.scale),
        "extract_features_batch": lambda: extract_features_batch([np.zeros((8, 8, 8), np.float32)]),
        "global_mesh": multihost.global_mesh,
        "extract_features_multihost": lambda: multihost.extract_features_multihost([np.zeros((8, 8, 8), np.float32)]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
