"""PyTorch port: M1's plain version (kNN) against the JAX package's kNN.

``knn_cuda.knn_topk_plain`` (through ``match.knn.knn_search`` on the CPU)
against ``sift3d.match.knn.knn_search`` and ``knn_search_tiled``:
- integer rows (the .key descriptors' case) with heavy ties: indices
  equal exactly (the lowest index first among equal distances, lax.top_k's
  order) and distances equal exactly (integers, exact in any order);
- 67-column rows (-g: integer descriptors and three float geometry
  columns, whose distances cancel to a few ulps of the norms): distances
  within 1e-5 of the norms' scale, indices equal wherever the JAX
  distances separate by more than that (the port sums in XLA's CPU order,
  so in practice both are exact);
- empty query sets and databases give zeros, k > N raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.match.knn import knn_search as jx_knn_search
from sift3d.match.knn import knn_search_tiled as jx_knn_tiled
from sift3d_torch.kernels import knn_cuda
from sift3d_torch.match.knn import knn_search

torch.set_num_threads(1)


def _tie_rows(rng, n, alphabet):
    """Rows of 64 values from a small alphabet: many equal distances."""
    return rng.choice(np.asarray(alphabet, np.float32), size=(n, 64)).astype(np.float32)


def _ranks(rng, n):
    return rng.permuted(np.tile(np.arange(64, dtype=np.float32), (n, 1)), axis=1)


def _geometry(rng, desc, weight=0.5):
    xyz = rng.uniform(10, 60, (desc.shape[0], 3)).astype(np.float32)
    scale = rng.uniform(1.5, 6, desc.shape[0]).astype(np.float32)
    return np.concatenate([desc, (weight * xyz / scale[:, None]).astype(np.float32)], axis=1)


def _port(q, db, k):
    d, i = knn_search(q, db, k, device="cpu")
    return d.numpy(), i.numpy()


@pytest.mark.parametrize(
    "kind, nq, nd, k",
    [
        ("ties4", 40, 300, 5),  # values from a 4-letter alphabet
        ("ties2", 33, 257, 8),  # from {0, 1}: almost every distance ties
        ("ranks", 50, 200, 5),  # GoH rank rows
        ("duplicates", 30, 120, 12),  # every row repeated: exact zero ties
    ],
)
def test_integer_rows_equal_jax_exactly(kind, nq, nd, k, rng):
    if kind == "ties4":
        db, q = _tie_rows(rng, nd, [0, 1, 2, 3]), _tie_rows(rng, nq, [0, 1, 2, 3])
    elif kind == "ties2":
        db, q = _tie_rows(rng, nd, [0, 1]), _tie_rows(rng, nq, [0, 1])
    elif kind == "ranks":
        db, q = _ranks(rng, nd), _ranks(rng, nq)
    else:
        base = _ranks(rng, nd // 4)
        db = np.repeat(base, 4, axis=0)
        q = base[rng.integers(0, len(base), nq)]
    d, i = _port(q, db, k)
    jd, ji = (np.asarray(a) for a in jx_knn_search(jnp.asarray(q), jnp.asarray(db), k))
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(d, jd)
    td, ti = jx_knn_tiled(q, jnp.asarray(db), k)
    np.testing.assert_array_equal(i, ti)
    np.testing.assert_array_equal(d, td)
    # the tie order is (distance, index), computed independently
    full = ((q[:, None, :].astype(np.int64) - db[None].astype(np.int64)) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(nd), full.shape), full), axis=1)[:, :k]
    np.testing.assert_array_equal(i, order)
    if kind != "ranks":
        assert (np.diff(d, axis=1) == 0).mean() > 0.1  # the cell really ties


@pytest.mark.parametrize("nq, nd", [(60, 300), (20, 513)])
def test_geometry_rows_within_f32_of_jax(nq, nd, rng):
    db = _geometry(rng, _ranks(rng, nd))
    q = np.concatenate([db[rng.integers(0, nd, nq // 2)], _geometry(rng, _ranks(rng, nq - nq // 2))])
    d, i = _port(q, db, 5)
    jd, ji = jx_knn_tiled(q, jnp.asarray(db), 5)
    scale = float(np.max((db * db).sum(1)))
    tol = 1e-5 * scale
    np.testing.assert_allclose(d, jd, rtol=0, atol=tol)
    # indices may swap only between neighbours closer than the tolerance
    sep = np.ones_like(jd, bool)
    sep[:, 1:] &= np.diff(jd, axis=1) > tol
    sep[:, :-1] &= np.diff(jd, axis=1) > tol
    np.testing.assert_array_equal(i[sep], ji[sep])
    print(f"{nq}x{nd} -g rows: distances exact {np.mean(d == jd):.4f}, indices equal {np.mean(i == ji):.4f}")


def test_empty_sets_and_k_above_n(rng):
    db = _ranks(rng, 6)
    for q, base, k in ((np.zeros((0, 64), np.float32), db, 3), (_ranks(rng, 4), np.zeros((0, 64), np.float32), 3),
                       (_ranks(rng, 4), db, 0)):
        d, i = _port(q, base, k)
        jd, ji = jx_knn_tiled(q, jnp.asarray(base), k)
        assert d.shape == jd.shape == (q.shape[0], k) and i.dtype == np.int64
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(i, ji)
    with pytest.raises(AssertionError):
        jx_knn_tiled(_ranks(rng, 2), jnp.asarray(db), 7)
    with pytest.raises(ValueError, match="exceeds"):
        knn_search(_ranks(rng, 2), db, 7, device="cpu")


def test_norms_sum_in_xla_windows(rng):
    """The plain norms follow XLA's windowed reduce: at 67 columns, the
    windows [0, 18), [18, 50), [50, 67); the JAX kNN's own norms are
    reproduced bit for bit on float rows."""
    assert knn_cuda.norm_windows(67) == [(0, 18), (18, 50), (50, 67)]
    assert knn_cuda.norm_windows(64) == [(0, 32), (32, 64)]
    for c in (64, 67):
        x = (rng.standard_normal((500, c)) * np.exp(rng.standard_normal((500, c)) * 3)).astype(np.float32)
        got = knn_cuda.sq_norms(torch.from_numpy(x)).numpy()
        want = np.asarray(jx_knn_search(jnp.asarray(x), jnp.asarray(np.zeros((256, c), np.float32)), 1)[0])[:, 0]
        np.testing.assert_array_equal(got, want)
