"""PyTorch port: the multi-device layer (sift3d_torch.dist: batch, gather,
solve) on the CPU, every mesh entry "cpu" (the JAX tests' 8 simulated
devices are one CPU too).

Against the port's single-device results, bit for bit:
- extract_features_batch (placement) against extract_features_many at 1, 3,
  4 and 8 entries, on tests/multihost_worker.py's 32^3 blob volumes, four of
  a second shape (32x24x40) and a zero volume;
- sharded_knn against knn_search at 1, 3 and 8 entries: rows from a
  4-letter alphabet (tied distances; the (distance, index) order), 67-column
  -g rows, a query set whose size is no multiple of the mesh, fewer queries
  than entries, an empty query set, and k > N raising alike;
- solve_similarity_sharded against the weighted solve_similarity at mesh
  sizes 1, 2, 3, 5 and 8 and at several N.
Against the JAX package on its 8-device CPU mesh (tests/conftest.py):
- extract_features_batch on test_torch_extract_many.py's three exact 64^3
  cells and a zero volume, at that file's tolerances;
- sharded_knn's indices equal to JAX sharded_knn's, gather_keypoint_sets
  equal;
- the sharded solve at tests/test_dist.py:121-130's tolerances, and within
  1e-9 of an f64 replay (the JAX package solves in f32);
- initial_blur_batch / octave_step_batch as tests/test_dist.py:47-60 holds
  JAX's, and equal to the port's per-volume pyramid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.dist import batch as jx_batch
from sift3d.dist import gather as jx_gather
from sift3d.dist import mesh as jx_mesh
from sift3d.dist import solve as jx_solve
from sift3d_torch import extract_features_batch as exported
from sift3d_torch.core.config import SiftConfig
from sift3d_torch.dist import batch, gather, solve
from sift3d_torch.match.knn import knn_search
from sift3d_torch.match.solve import solve_similarity
from sift3d_torch.pipeline import pyramid
from sift3d_torch.pipeline.extract import extract_features_many
from sift3d_torch.utils.synthetic import repeatability, synthetic_blob_texture, synthetic_volume

torch.set_num_threads(1)
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
EXACT_NAMES = ["synthetic64_s3", "synthetic64_s7", "texture64", "zeros64"]


def _blobs(seed, shape=(32, 32, 32), n=8):
    """tests/multihost_worker.py's blob volume, on any grid."""
    z, y, x = np.mgrid[0 : shape[0], 0 : shape[1], 0 : shape[2]].astype(np.float32)
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for _ in range(n):
        bc = r.uniform(6, np.array(shape) - 6)
        s = r.uniform(1.8, 3.5)
        a = r.uniform(60, 250)
        vol += a * np.exp(-(((z - bc[0]) ** 2 + (y - bc[1]) ** 2 + (x - bc[2]) ** 2) / (2 * s * s)))
    return vol


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must simulate 8 CPU devices"
    return jx_mesh.make_mesh(batch=8, space=1)


@pytest.fixture(scope="module")
def volumes():
    """Two shapes, a zero volume last: 10 volumes, so 8 entries hold 1 or 2."""
    vols = [_blobs(s) for s in range(1, 6)] + [_blobs(s, (32, 24, 40), 12) for s in range(6, 10)]
    return vols + [np.zeros((32, 32, 32), np.float32)]


@pytest.fixture(scope="module")
def many(volumes):
    return extract_features_many(volumes, device="cpu")


def _assert_same(got, want):
    assert len(got) == len(want)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("entries", [1, 3, 4, 8])
def test_placement_equals_many(volumes, many, entries):
    assert len(many[-1]) == 0 and min(len(f) for f in many[:-1]) > 0
    got = batch.extract_features_batch(volumes, ["cpu"] * entries)
    assert len(got) == len(volumes)
    for g, w in zip(got, many):
        _assert_same(g, w)


def test_placement_takes_tensors_and_keeps_order(volumes, many):
    order = [9, 2, 6, 0]
    got = exported([torch.from_numpy(volumes[i]) for i in order], ["cpu", "cpu"])
    for g, i in zip(got, order):
        _assert_same(g, many[i])
    assert batch.extract_features_batch([], ["cpu"]) == []


def test_placement_raises_an_entry_error_and_needs_a_card_by_default(monkeypatch):
    with pytest.raises(ValueError, match="Z, Y, X"):
        batch.extract_features_batch([np.zeros((8, 8, 8), np.float32), np.zeros((8, 8), np.float32)], ["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        batch.extract_features_batch([np.zeros((8, 8, 8), np.float32)])


@pytest.fixture(scope="module")
def exact_volumes():
    """test_torch_extract_many.py's exact 64^3 cells and a zero volume."""
    return [
        synthetic_volume(64, seed=3),
        synthetic_volume(64, seed=7),
        synthetic_blob_texture((64, 64, 64), seed=7, n_blobs=30),
        np.zeros((64, 64, 64), np.float32),
    ]


@pytest.fixture(scope="module")
def jax_batch(exact_volumes, mesh8):
    return jx_batch.extract_features_batch(exact_volumes, mesh8, JxConfig(feature_chunk=128))


@pytest.fixture(scope="module")
def port_batch(exact_volumes):
    return batch.extract_features_batch(exact_volumes, ["cpu"] * 8)


@pytest.mark.parametrize("i", range(len(EXACT_NAMES)), ids=EXACT_NAMES)
def test_placement_matches_jax(jax_batch, port_batch, i):
    """test_torch_extract_many.py's tolerances, volume by volume."""
    want, got = jax_batch[i], port_batch[i]
    if EXACT_NAMES[i] == "zeros64":
        assert len(got) == len(want) == 0
        return
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ori, want.ori, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.eigs, want.eigs, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.info, want.info)
    assert (got.desc == want.desc).all(axis=1).mean() >= 0.99


def _knn_rows(kind):
    rng = np.random.default_rng(11)
    if kind == "4-letter":  # tied distances everywhere
        return rng.choice(np.float32([0, 1, 2, 3]), (203, 64)), None
    if kind == "-g 0.5":  # rank descriptors and three float geometry columns
        ranks = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (150, 1)), axis=1)
        geo = 0.5 * rng.uniform(0, 60, (150, 3)) / rng.uniform(1.5, 6, (150, 1))
        return np.concatenate([ranks, geo.astype(np.float32)], axis=1), None
    db = rng.standard_normal((64, 64)).astype(np.float32)
    n = {"3 queries": 3, "no queries": 0}[kind]
    return db, db[:n]


@pytest.mark.parametrize("entries", [1, 3, 8])
@pytest.mark.parametrize("kind", ["4-letter", "-g 0.5", "3 queries", "no queries"])
def test_sharded_knn_equals_knn_search(kind, entries):
    db, queries = _knn_rows(kind)
    queries = db if queries is None else queries
    want = knn_search(queries, db, 5, device="cpu")
    got = gather.sharded_knn(queries, db, 5, ["cpu"] * entries)
    assert got[0].shape == (queries.shape[0], 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sharded_knn_edges():
    db = np.eye(4, 64, dtype=np.float32)
    with pytest.raises(ValueError, match="k exceeds database size"):
        gather.sharded_knn(db, db, 5, ["cpu"] * 3)
    d, i = gather.sharded_knn(db, db[:0], 3, ["cpu"] * 3)
    assert d.shape == i.shape == (4, 3) and not d.any() and not i.any()
    assert gather.split_bounds(10, 4) == [0, 3, 6, 8, 10]


@pytest.mark.parametrize("kind", ["float", "ranks"])
def test_sharded_knn_indices_match_jax(mesh8, kind):
    rng = np.random.default_rng(5)
    if kind == "float":
        db = rng.standard_normal((64, 64)).astype(np.float32)
    else:  # exact integer distances: equal ties break to the lower index in both
        db = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (64, 1)), axis=1)
        db[32:] = db[:32]
    q = db[:40]
    _, want = jx_gather.sharded_knn(jnp.asarray(q), jnp.asarray(db), 4, mesh8)
    _, got = gather.sharded_knn(q, db, 4, ["cpu"] * 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_keypoint_sets_matches_jax(mesh8):
    desc = np.random.default_rng(1234).standard_normal((8, 5, 16)).astype(np.float32)
    local = jax.device_put(jnp.asarray(desc), NamedSharding(mesh8, P("batch", None, None)))
    want = np.asarray(jx_gather.gather_keypoint_sets(local, mesh8))
    got = gather.gather_keypoint_sets([torch.from_numpy(desc[i : i + 1]) for i in range(8)], ["cpu"] * 8)
    assert len(got) == 8
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)
    with pytest.raises(ValueError, match="one block per mesh entry"):
        gather.gather_keypoint_sets([torch.from_numpy(desc[0])], ["cpu"] * 2)


def _correspondences(n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    q = (1.5 * p + np.array([1.0, -2.0, 3.0]) + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    return p, q, rng.uniform(0.5, 1.5, n).astype(np.float32)


@pytest.mark.parametrize("entries", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 3, 80, 1000, 1025])
def test_sharded_solve_equals_weighted_solve(n, entries):
    p, q, w = _correspondences(n)
    want = solve_similarity(p, q, w, device="cpu")
    got = solve.solve_similarity_sharded(p, q, w, ["cpu"] * entries)
    assert got[0] == want[0] and np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    # weights of 1 are the unweighted fit (the --refine call)
    unit = solve.solve_similarity_sharded(p, q, np.ones(n, np.float32), ["cpu"] * entries)
    assert np.array_equal(unit[2], solve_similarity(p, q, device="cpu")[2])


def _replay(p, q, w):
    """The weighted Umeyama fit in f64 numpy."""
    p, q, w = (np.asarray(a, np.float64) for a in (p, q, w))
    pb, qb = (w @ p) / w.sum(), (w @ q) / w.sum()
    cov = np.einsum("n,ni,nj->ij", w, q, p) / w.sum() - np.outer(qb, pb)
    u, s, vt = np.linalg.svd(cov)
    dg = np.array([1.0, 1.0, np.sign(np.linalg.det(u) * np.linalg.det(vt))])
    rot = (u * dg) @ vt
    scale = (s * dg).sum() / ((w * (p * p).sum(1)).sum() / w.sum() - pb @ pb)
    return scale, rot, qb - scale * rot @ pb


def test_sharded_solve_matches_jax(mesh8):
    """tests/test_dist.py:121-130's fixture and tolerances."""
    rng = np.random.default_rng(1234)
    n = 80
    p = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    q = (2.0 * p + np.array([1.0, 2.0, 3.0])).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    js, jr, jt = jx_solve.solve_similarity_sharded(p, q, w, mesh8)
    s, r, t = solve.solve_similarity_sharded(p, q, w, ["cpu"] * 8)
    np.testing.assert_allclose(s, 2.0, rtol=1e-4)
    np.testing.assert_allclose(r, np.eye(3), atol=1e-4)
    np.testing.assert_allclose(t, [1, 2, 3], atol=1e-3)
    np.testing.assert_allclose(s, js, rtol=1e-4)
    np.testing.assert_allclose(r, jr, atol=1e-4)
    np.testing.assert_allclose(t, jt, atol=1e-3)
    rs, rr, rt = _replay(p, q, w)
    assert abs(s - rs) <= 1e-9 and np.abs(r - rr).max() <= 1e-9 and np.abs(t - rt).max() <= 1e-9


def test_batch_octave_step_matches_jax(mesh8):
    """tests/test_dist.py:47-60 on the port: 8 volumes of 12^3 as one batch."""
    vols = np.random.default_rng(1234).standard_normal((8, 12, 12, 12)).astype(np.float32)
    jcfg = JxConfig()
    vb = jax.device_put(jnp.asarray(vols), NamedSharding(mesh8, P("batch", None, None, None)))
    want = jx_batch.octave_step_batch(jx_batch.initial_blur_batch(vb, jcfg), jcfg)
    cfg = SiftConfig()
    gstack, dogs, mask, next_base = batch.octave_step_batch(batch.initial_blur_batch(torch.from_numpy(vols), cfg), cfg)
    assert gstack.shape == (8, 6, 12, 12, 12) and next_base.shape == (8, 6, 6, 6)
    np.testing.assert_allclose(dogs.numpy(), np.asarray(want.dogs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gstack.numpy(), np.asarray(want.gstack), rtol=1e-4, atol=1e-5)
    single = pyramid.octave_core(pyramid.initial_blur_core(torch.from_numpy(vols[3]), cfg), cfg)
    for got, w in zip((gstack[3], dogs[3], mask[3], next_base[3]), single):
        assert torch.equal(got, w)
