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
it never holds more than ``PLAIN_CHUNK`` distances. The kernel never forms
the [Q, N] matrix (``csrc/knn_topk.cu``).
"""

from __future__ import annotations

import torch

from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.kernels import cuda_lib

KERNEL_COLUMNS = (64, 67)  # descriptors, and with -g's three geometry columns
MAX_K = 32
PLAIN_CHUNK = 1 << 26  # distances held at once by the plain version


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


def knn_topk(q: torch.Tensor, db: torch.Tensor, k: int):
    """M1 (see knn_topk_plain): the plain version for CPU tensors, the
    kernel for CUDA tensors (C in KERNEL_COLUMNS, k <= MAX_K)."""
    if not 1 <= k <= db.shape[0]:
        raise ValueError(f"k must be in [1, {db.shape[0]}], got {k}")
    if cuda_lib.route(q) == "plain":
        return knn_topk_plain(q, db, k)
    cuda_lib.require_cuda(q, "q", torch.float32, 2)
    cuda_lib.require_cuda(db, "db", torch.float32, 2)
    nq, c = q.shape
    if db.shape[1] != c or db.device != q.device:
        raise ValueError(f"db must be [N, {c}] on {q.device}, got {tuple(db.shape)} on {db.device}")
    if c not in KERNEL_COLUMNS or k > MAX_K:
        raise ValueError(f"the kernel takes C in {KERNEL_COLUMNS} and k <= {MAX_K}, got C={c}, k={k}")
    dist = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=q.device)
    if nq == 0:
        return dist, idx
    cuda_lib.launch("sift3d_knn_topk", q, db, dist, idx, nq, db.shape[0], c, k, device=q.device)
    cuda_lib.count_launch(knn_topk)
    return dist, idx


knn_topk.launches = 0
