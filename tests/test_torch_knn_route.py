"""PyTorch port: M1's two routes and its split database, on the CPU.

- ``knn_cuda.int8_route`` takes the int8 tensor-core route exactly for rows
  whose first 64 columns are integers in -128..127: .key descriptors, GoH
  ranks, -g's 67-column rows (an integer prefix and a float tail); float
  rows, integers out of range, NaN and inf take the f32 route.
- ``knn_cuda.knn_topk_split_plain`` (each database slice's k best, merged
  by (distance, index)), at the slices ``int8_plan`` cuts, S in {1, 2, 3,
  4, 7}, equals ``knn_topk_plain`` exactly, distances and indices, on
  tie-heavy 4-letter rows, on rows with every row repeated and on -g rows,
  and equals the JAX package's ``sift3d.match.knn.knn_search`` on integer
  rows.
- ``knn_cuda.int8_plan``: slices of whole tiles that cover the database,
  one slice when the queries fill the card's wave, several for a quarter
  shard, fewer where the card holds fewer blocks (larger k).
- ``knn_cuda.knn_topk_int8`` refuses rows outside its route; ``knn_topk``
  and ``knn_search`` choose the route from the data alone.
- On a CUDA card (marker ``cuda``): both routes' kernels and the split
  against the plain version, and the int8 wrapper's refusal of float rows. This file imports JAX only inside the tests
  that compare with it, so ``python -m pytest --noconftest -m cuda
  tests/test_torch_knn_route.py`` runs where JAX is missing.
"""

import numpy as np
import pytest
import torch

from sift3d_torch.kernels import knn_cuda
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.match.knn import knn_search

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


def _letters(rng, n, alphabet=(0, 1, 2, 3)):
    return rng.choice(np.asarray(alphabet, np.float32), size=(n, 64))


def _ranks(rng, n):
    return rng.permuted(np.tile(np.arange(64, dtype=np.float32), (n, 1)), axis=1)


def _geometry(rng, desc, weight=0.5):
    xyz = rng.uniform(10, 60, (desc.shape[0], 3))
    scale = rng.uniform(1.5, 6, desc.shape[0])
    return np.concatenate([desc, weight * xyz / scale[:, None]], axis=1).astype(np.float32)


def _rows(kind, rng, n):
    if kind == "int8 range":
        return rng.integers(-128, 128, (n, 64)).astype(np.float32)
    if kind == "GoH ranks":
        return _ranks(rng, n)
    if kind == "-g 67 columns":
        return _geometry(rng, _ranks(rng, n))
    if kind == "4-letter":
        return _letters(rng, n)
    if kind == "repeated":
        return np.repeat(_ranks(rng, -(-n // 4)), 4, axis=0)[:n]
    if kind == "float":
        return rng.standard_normal((n, 64)).astype(np.float32)
    if kind == "one float value":
        x = _ranks(rng, n)
        x[n // 2, 17] += 0.5
        return x
    if kind == "128":
        x = rng.integers(-128, 128, (n, 64)).astype(np.float32)
        x[3, 63] = 128.0
        return x
    if kind == "-129":
        x = rng.integers(-128, 128, (n, 64)).astype(np.float32)
        x[0, 0] = -129.0
        return x
    if kind == "NaN":
        x = _ranks(rng, n)
        x[1, 2] = np.nan
        return x
    if kind == "inf":
        x = _ranks(rng, n)
        x[2, 5] = np.inf
        return x
    raise ValueError(kind)


# M1's int8 route: its pre-pass, its main kernel and the slices' merge
INT8_ENTRIES = ("sift3d_knn_prep_i8", "sift3d_knn_topk_i8", "sift3d_knn_merge")
ROUTES = {"int8 range": True, "GoH ranks": True, "-g 67 columns": True, "4-letter": True, "repeated": True,
          "float": False, "one float value": False, "128": False, "-129": False, "NaN": False, "inf": False}


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_route_check(kind, rng):
    x = torch.from_numpy(_rows(kind, rng, 50))
    ok = torch.from_numpy(_ranks(rng, 40) if x.shape[1] == 64 else _geometry(rng, _ranks(rng, 40)))
    assert knn_cuda.int8_route(x, x) is ROUTES[kind]
    # both sides are checked
    assert knn_cuda.int8_route(x, ok) is ROUTES[kind]
    assert knn_cuda.int8_route(ok, x) is ROUTES[kind]


def test_route_needs_64_columns(rng):
    x = torch.from_numpy(_ranks(rng, 10)[:, :32].copy())
    assert knn_cuda.int8_route(x, x) is False


def _plan(nq, nd, slices):
    """int8_plan's cut of nd rows (7 tiles) into `slices` slices: a card
    that holds as many blocks as the slices asked for."""
    plan = knn_cuda.int8_plan(nq, nd, slices)
    assert plan[0] == slices
    return plan


@pytest.mark.parametrize("slices", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("kind, nq, nd, k", [("4-letter", 60, 770, 5), ("repeated", 40, 800, 8),
                                             ("-g 67 columns", 50, 780, 5)])
def test_split_equals_whole(kind, nq, nd, k, slices, rng):
    db = torch.from_numpy(_rows(kind, rng, nd))
    q = torch.cat([db[torch.from_numpy(rng.integers(0, nd, nq // 2))],
                   torch.from_numpy(_rows(kind, rng, nq - nq // 2))])
    want = knn_cuda.knn_topk_plain(q, db, k)
    got = knn_cuda.knn_topk_split_plain(q, db, k, *_plan(nq, nd, slices))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind != "-g 67 columns":
        assert float((want[0][:, 1:] == want[0][:, :-1]).float().mean()) > 0.1  # the rows really tie


@pytest.mark.parametrize("slices", [1, 2, 3, 4, 7])
def test_split_equals_jax(slices, rng):
    import jax.numpy as jnp

    from sift3d.match.knn import knn_search as jx_knn_search

    db = _letters(rng, 800)
    q = np.concatenate([db[rng.integers(0, 800, 20)], _letters(rng, 30)])
    got = knn_cuda.knn_topk_split_plain(torch.from_numpy(q), torch.from_numpy(db), 6, *_plan(50, 800, slices))
    jd, ji = (np.asarray(a) for a in jx_knn_search(jnp.asarray(q), jnp.asarray(db), 6))
    np.testing.assert_array_equal(got[0].numpy(), jd)
    np.testing.assert_array_equal(got[1].numpy(), ji)


def test_split_takes_slices_shorter_than_k(rng):
    """Slices of fewer rows than k: 9 rows cut into slices of 1, 2 and 3."""
    db = torch.from_numpy(_letters(rng, 9))
    q = torch.from_numpy(_letters(rng, 12))
    want = knn_cuda.knn_topk_plain(q, db, 4)
    for rows in (1, 2, 3):
        got = knn_cuda.knn_topk_split_plain(q, db, 4, -(-9 // rows), rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        knn_cuda.knn_topk_split_plain(q, db, 4, 5, 3)  # slices left empty


@pytest.mark.parametrize("nq, n, places, want_slices", [
    (48_000, 48_000, 396, 1), (12_000, 48_000, 396, 4), (24_000, 24_000, 396, 2), (25_400, 48_000, 396, 1),
    (25, 80, 396, 1), (25, 300, 396, 3), (1, 129, 396, 2), (500, 120, 396, 1), (500, 1000, 396, 8),
    (12_000, 48_000, 264, 2), (12_000, 48_000, 132, 1), (1_000, 48_000, 132, 16)])
def test_int8_plan(nq, n, places, want_slices):
    slices, rows = knn_cuda.int8_plan(nq, n, places)
    assert slices == want_slices
    assert rows % knn_cuda.INT8_TILE == 0
    assert (slices - 1) * rows < n <= slices * rows  # every slice holds rows
    # the blocks fit the card's one wave, or there is a slice a tile
    blocks = -(-nq // knn_cuda.INT8_QUERIES)
    assert blocks * slices <= max(places, blocks) or rows == knn_cuda.INT8_TILE


def test_knn_topk_takes_the_plain_version_on_the_cpu(rng):
    q = torch.from_numpy(_rows("-g 67 columns", rng, 30))
    db = torch.from_numpy(_rows("-g 67 columns", rng, 90))
    want = knn_cuda.knn_topk_plain(q, db, 5)
    for got in (knn_cuda.knn_topk(q, db, 5), knn_cuda.knn_topk_int8(q, db, 5), knn_cuda.knn_topk_f32(q, db, 5),
                knn_search(q, db, 5, device="cpu")):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", sorted(k for k, int8 in ROUTES.items() if not int8))
def test_int8_wrapper_refuses_other_rows(kind, rng):
    """Rows outside the int8 route raise in knn_topk_int8, on either side,
    and take the f32 route's answer through knn_topk."""
    x = torch.from_numpy(_rows(kind, rng, 50))
    ok = torch.from_numpy(_ranks(rng, 40))
    for q, db in ((x, x), (x, ok), (ok, x)):
        with pytest.raises(ValueError, match="int8 route"):
            knn_cuda.knn_topk_int8(q, db, 3)
    if kind not in ("NaN", "inf"):
        want = knn_cuda.knn_topk_plain(x, ok, 3)
        got = knn_cuda.knn_topk(x, ok, 3)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_both_routes_and_the_split_on_the_card(rng):
    """The int8 kernel (one slice and several, with the merge) and the f32
    kernel against the plain version on the same CUDA tensors, exactly; the
    launches each route counts; the int8 wrapper refuses float rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    for kind, k, n in (("int8 range", 5, 1000), ("4-letter", 8, 1000), ("repeated", 3, 1000),
                       ("-g 67 columns", 5, 1000), ("float", 5, 1000), ("4-letter", 32, 1000),
                       ("4-letter", 5, 120), ("-g 67 columns", 16, 120)):
        db = torch.from_numpy(_rows(kind, rng, n)).to(dev)
        q = torch.cat([db[:100], torch.from_numpy(_rows(kind, rng, 400)).to(dev)]).contiguous()
        want = knn_cuda.knn_topk_plain(q, db, k)
        assert knn_cuda.int8_route(q, db) is ROUTES[kind]
        if ROUTES[kind]:
            # 1000 rows: 8 slices and the merge; 120 rows: one slice
            before = [launches(e) for e in INT8_ENTRIES]
            got = knn_cuda.knn_topk_int8(q, db, k)
            torch.cuda.synchronize()
            assert knn_cuda.int8_plan(q.shape[0], n, knn_cuda.int8_places(dev, q.shape[1], k))[0] == (
                8 if n == 1000 else 1)
            launched = [launches(e) - b for e, b in zip(INT8_ENTRIES, before)]
            assert launched == [1, 1, 1 if n == 1000 else 0], kind
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (kind, k, n)
        else:
            before = [launches(e) for e in INT8_ENTRIES]
            with pytest.raises(ValueError, match="int8 route"):
                knn_cuda.knn_topk_int8(q, db, k)
            assert [launches(e) for e in INT8_ENTRIES] == before
        before = launches("sift3d_knn_topk")
        got = knn_cuda.knn_topk_f32(q, db, k)
        torch.cuda.synchronize()
        assert launches("sift3d_knn_topk") == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kind
