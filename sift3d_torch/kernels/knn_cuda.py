"""M1: exact kNN under squared L2 (CUDA kernel + plain form).

:func:`knn_topk` replaces the XLA program of ``sift3d.match.knn``
(``knn_search``: the distance matrix as one MXU einsum, then
``lax.top_k``). For each query it returns the k smallest distances
``max((|q|^2 + |d|^2) - 2 q.d, 0)`` and their database indices, ascending
by (distance, index): ``lax.top_k``'s order. Descriptors read from a .key
file are integers, so distances are exact integers and tie often; the tie
order is part of the result.

Both versions sum in the order of XLA's CPU code for the JAX kNN: the dot
product an fma chain over the columns in order (Eigen's), each norm
XLA's windowed reduce (:func:`sq_norms`), so they agree to the bit with
each other and, on the 67-column rows of ``-g`` (integer descriptors and
three float geometry columns, whose distances cancel to a few ulps of the
norms), with the JAX package; the plain version's fmas are
``numerics.fma_exact``. The plain version sorts unique
int64 keys, the distance's float bits above the index, so ``torch.topk``
has one answer on every device; it works through the queries in chunks, so
it never holds more than ``PLAIN_CHUNK`` distances. The kernels never form
the [Q, N] matrix (``csrc/knn_topk.cu``).

On the card M1 has two routes, which :func:`knn_topk` chooses from the
data by :func:`int8_route`: rows whose first 64 columns are integers in
-128..127 (every ``.key`` descriptor, GoH ranks, the descriptor part of
``-g``'s rows) take :func:`knn_topk_int8`, an int8 tensor-core product
(exact there, so the same bits as the fma chain) whose database may be cut
into slices (:func:`int8_plan`) merged by (distance, index); any other
rows take :func:`knn_topk_f32`, the f32 fma chains. :func:`knn_topk_int8`
refuses rows outside its route. :func:`knn_topk_plain` is the plain
version of both, and :func:`knn_topk_split_plain` the plain form of the
slices and their merge.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.kernels import cuda_lib

KERNEL_COLUMNS = (64, 67)  # descriptors, and with -g's three geometry columns
MAX_K = 32
PLAIN_CHUNK = 1 << 26  # distances held at once by the plain version
INT8_COLUMNS = 64  # the columns the int8 route multiplies on the tensor cores
INT8_TILE = 128  # database rows a shared-memory tile of the int8 kernel (knn_topk.cu kI8Tile)
INT8_QUERIES = 128  # queries a block of the int8 kernel (kI8Queries)


def norm_windows(c: int) -> list:
    """The column windows XLA's CPU reduce sums a row of c squares in: one
    for c <= 32, else windows of 32 with the padding split evenly (c = 67:
    [0, 18), [18, 50), [50, 67))."""
    if c <= 32:
        return [(0, c)]
    nw = -(-c // 32)
    left = (nw * 32 - c) // 2
    return [(max(0, 32 * w - left), min(c, 32 * w + 32 - left)) for w in range(nw)]


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """[N, C] -> [N] squared norms: the squares rounded, each window summed
    from 0 in column order, the window sums added from 0 (the kernels'
    ``window_sq_norm``)."""
    sq = x * x
    tot = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for lo, hi in norm_windows(x.shape[1]):
        acc = torch.zeros_like(tot)
        for c in range(lo, hi):
            acc = acc + sq[:, c]
        tot = tot + acc
    return tot


def exact_prefix(q: torch.Tensor, db: torch.Tensor) -> int:
    """The number of leading columns over which every fma of the dot's chain
    is exact: integer values whose products' magnitudes, summed, stay below
    2^24 (descriptor ranks 0..63, or the .key file's -128..127)."""
    if q.shape[0] == 0 or db.shape[0] == 0:
        return 0
    integer = (q == q.round()).all(0) & (db == db.round()).all(0)
    bound = torch.cumsum(q.abs().amax(0).double() * db.abs().amax(0).double(), 0)
    ok = (integer & (bound < 2.0**24)).tolist()
    return ok.index(False) if False in ok else len(ok)


def dist_sqr_plain(q: torch.Tensor, db: torch.Tensor, dn: torch.Tensor = None) -> torch.Tensor:
    """[Q, C] x [N, C] -> [Q, N] squared distances in the kernels' order:
    (|q|^2 + |d|^2) - 2 * (q . d), the dot an fma chain over c from 0,
    clamped at +0. Over the exact prefix of columns (:func:`exact_prefix`)
    the chain's every step is exact, so it equals the integer dot product,
    which an f64 matmul gives exactly; the chain runs on from there."""
    dn = sq_norms(db) if dn is None else dn
    p = exact_prefix(q, db)
    cross = (q[:, :p].double() @ db[:, :p].double().T).float()
    for c in range(p, q.shape[1]):
        cross = fma_exact(q[:, c, None], db[None, :, c], cross)
    d2 = (sq_norms(q)[:, None] + dn[None, :]) - 2.0 * cross
    return torch.where(d2 > 0, d2, torch.zeros((), dtype=torch.float32, device=q.device))


def knn_topk_plain(q: torch.Tensor, db: torch.Tensor, k: int):
    """q [Q, C], db [N, C] f32, 1 <= k <= N -> (dist [Q, k] f32, idx [Q, k]
    int64): the k smallest by (distance, index)."""
    n = db.shape[0]
    dn = sq_norms(db)
    index = torch.arange(n, dtype=torch.int64, device=q.device)
    step = max(1, PLAIN_CHUNK // max(n, 1))
    dists, idxs = [], []
    for q0 in range(0, q.shape[0], step):
        d2 = dist_sqr_plain(q[q0 : q0 + step], db, dn)
        # distances are >= +0, so their bits order like their values
        keys = (d2.view(torch.int32).to(torch.int64) << 32) | index
        top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        dists.append((top >> 32).to(torch.int32).view(torch.float32))
        idxs.append(top & 0xFFFFFFFF)
    if not dists:
        return torch.zeros((0, k), dtype=torch.float32, device=q.device), torch.zeros(
            (0, k), dtype=torch.int64, device=q.device
        )
    return torch.cat(dists), torch.cat(idxs)


def knn_topk_split_plain(q: torch.Tensor, db: torch.Tensor, k: int, slices: int, slice_rows: int):
    """knn_topk_plain with the database cut as the int8 kernel cuts it
    (int8_plan): slice s is rows [s * slice_rows, min(N, (s + 1) *
    slice_rows)); each slice's k best (fewer when it has fewer rows), then
    the k smallest of their union by (distance, index), as the merge
    kernel takes them. Equal to knn_topk_plain."""
    n = db.shape[0]
    if not 1 <= k <= n or slices < 1 or slices * slice_rows < n or (slices - 1) * slice_rows >= n:
        raise ValueError(f"need 1 <= k <= {n} and {slices} non-empty slices of {slice_rows} rows covering {n}")
    parts = []
    for lo in range(0, n, slice_rows):
        hi = min(n, lo + slice_rows)
        dist, idx = knn_topk_plain(q, db[lo:hi], min(k, hi - lo))
        parts.append((dist, idx + lo))
    d = torch.cat([dist for dist, _ in parts], dim=1)
    i = torch.cat([idx for _, idx in parts], dim=1)
    keys = (d.view(torch.int32).to(torch.int64) << 32) | i
    top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    return (top >> 32).to(torch.int32).view(torch.float32), top & 0xFFFFFFFF


def int8_route(q: torch.Tensor, db: torch.Tensor) -> bool:
    """Whether M1 takes its int8 route: the first 64 columns of q and of db
    are integers in -128..127 (NaN and inf are not). A few elementwise
    kernels and one reduction on the tensors' device, and one host read."""
    if q.shape[1] < INT8_COLUMNS:
        return False

    def ok(x):
        head = x[:, :INT8_COLUMNS]
        return (head == head.round().clamp(-128, 127)).all()

    return bool(ok(q) if q is db else ok(q) & ok(db))


def int8_plan(nq: int, n: int, places: int):
    """(slices, rows a slice) of the int8 kernel for nq queries against n
    rows on a card that holds `places` of its blocks at once
    (int8_places): as many slices of whole tiles as keep every block in
    that one wave, at least one, at most one a tile, none empty."""
    tiles = max(1, -(-n // INT8_TILE))
    blocks = max(1, -(-nq // INT8_QUERIES))
    per = -(-tiles // min(max(1, places // blocks), tiles))
    return -(-tiles // per), per * INT8_TILE


@functools.cache
def int8_places(device: torch.device, c: int, k: int) -> int:
    """The int8 main kernel's blocks that `device` holds at once for rows of
    c columns and k neighbours: the occupancy API's count an SM (its
    registers grow with k) times the SMs. One query of the card a (device,
    c, k)."""
    blocks = ctypes.c_int(0)
    cuda_lib.launch("sift3d_knn_i8_blocks_per_sm", c, k, ctypes.addressof(blocks), device=device)
    return blocks.value * torch.cuda.get_device_properties(device).multi_processor_count


def _check(q: torch.Tensor, db: torch.Tensor, k: int) -> None:
    cuda_lib.require_cuda(q, "q", torch.float32, 2)
    cuda_lib.require_cuda(db, "db", torch.float32, 2)
    c = q.shape[1]
    if db.shape[1] != c or db.device != q.device:
        raise ValueError(f"db must be [N, {c}] on {q.device}, got {tuple(db.shape)} on {db.device}")
    if c not in KERNEL_COLUMNS or not 1 <= k <= min(MAX_K, db.shape[0]):
        raise ValueError(f"the kernels take C in {KERNEL_COLUMNS} and 1 <= k <= min({MAX_K}, N), got C={c}, k={k}")


def _outputs(q: torch.Tensor, k: int):
    return (torch.empty((q.shape[0], k), dtype=torch.float32, device=q.device),
            torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device))


def knn_topk_f32(q: torch.Tensor, db: torch.Tensor, k: int):
    """M1's f32 route (see knn_topk_plain): the plain version for CPU
    tensors, the f32 kernel for CUDA tensors, any rows."""
    if cuda_lib.route(q) == "plain":
        return knn_topk_plain(q, db, k)
    _check(q, db, k)
    dist, idx = _outputs(q, k)
    if q.shape[0] == 0:
        return dist, idx
    cuda_lib.launch("sift3d_knn_topk", q, db, dist, idx, q.shape[0], db.shape[0], q.shape[1], k, device=q.device)
    return dist, idx


def knn_topk_int8(q: torch.Tensor, db: torch.Tensor, k: int):
    """M1's int8 route (see knn_topk_plain), for rows whose first 64 columns
    are integers in -128..127: raises ValueError for any others (int8_route,
    checked here). The plain version for CPU tensors; for CUDA tensors the
    pre-pass, the int8 kernel over int8_plan's database slices and, with
    more than one, the merge: two or three launches."""
    if not int8_route(q, db):
        raise ValueError("M1's int8 route takes rows whose first 64 columns are integers in -128..127")
    return _int8(q, db, k)


def _int8(q: torch.Tensor, db: torch.Tensor, k: int):
    """knn_topk_int8 on rows int8_route has passed."""
    if cuda_lib.route(q) == "plain":
        return knn_topk_plain(q, db, k)
    _check(q, db, k)
    dist, idx = _outputs(q, k)
    nq, c = q.shape
    n = db.shape[0]
    if nq == 0:
        return dist, idx
    s, rows = int8_plan(nq, n, int8_places(q.device, c, k))
    npad = -(-n // INT8_TILE) * INT8_TILE
    db8 = torch.empty((npad, INT8_COLUMNS // 4), dtype=torch.int32, device=q.device)
    dn = torch.empty(npad, dtype=torch.float32, device=q.device)
    tail = torch.empty((npad, 3), dtype=torch.float32, device=q.device) if c > INT8_COLUMNS else None
    cuda_lib.launch("sift3d_knn_prep_i8", db, db8, dn, tail, n, npad, c, device=q.device)
    if s == 1:
        cuda_lib.launch("sift3d_knn_topk_i8", q, db8, dn, tail, dist, idx, None, None, nq, n, c, k, 1, rows,
                        device=q.device)
        return dist, idx
    part_d = torch.empty((s, nq, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((s, nq, k), dtype=torch.int32, device=q.device)
    cuda_lib.launch("sift3d_knn_topk_i8", q, db8, dn, tail, None, None, part_d, part_i, nq, n, c, k, s, rows,
                    device=q.device)
    cuda_lib.launch("sift3d_knn_merge", part_d, part_i, dist, idx, nq, s, k, device=q.device)
    return dist, idx


def knn_topk(q: torch.Tensor, db: torch.Tensor, k: int):
    """M1 (see knn_topk_plain): the plain version for CPU tensors; for CUDA
    tensors (C in KERNEL_COLUMNS, k <= MAX_K) the int8 route where
    int8_route(q, db) holds, decided from the data, else the f32 route."""
    if not 1 <= k <= db.shape[0]:
        raise ValueError(f"k must be in [1, {db.shape[0]}], got {k}")
    if cuda_lib.route(q) == "plain":
        return knn_topk_plain(q, db, k)
    return _int8(q, db, k) if int8_route(q, db) else knn_topk_f32(q, db, k)
