"""Reference group match: ``featmatch -r -s4 -n<k> --all-to-all --refine``
without its output files, on the CPU.

Written from the algorithm of the repository's JAX package (``sift3d/``,
which follows the Toews featMatchMultiple binary), as plain NumPy. It
imports nothing of either package; it reads the ``.key`` files with the
benchmark's own parser. Per group call:

- each set read, its rows kept where (sum of eigenvalues)^3 < 140 times
  their product and then where the reoriented flag is set;
- the ratio test of every set against set 0, as the reference scans the
  database: a running (first, second) nearest pair over squared L2
  descriptor distances, where a new nearest displaces the old into second
  place, and a nearer second is taken, only when the new row is not
  geometrically compatible with the current nearest (log scale ratio
  < log 1.5, distance < 0.5 of its scale);
- per pair, the matches in ascending ratio (stable), at most 3000; with
  more than 3, every match a similarity hypothesis (its rotation from the
  two features' orientation triangles, its scale from their perimeters),
  scored by the matches it carries within the Hough thresholds (log scale
  < 1, shift < 2 scales, every orientation row's cosine > 0.7), the first
  best winning; its inliers; the transform about the model's bounding-box
  centre, refined (with at least 4 inliers) by a weighted least-squares
  similarity (Umeyama, f64 SVD);
- the group vote: every row's 5 nearest rows of all sets (ties by index),
  one vote a target image and none for its own, weights exp(-(d/dmin)^2)
  soft-maxed as log(w/sum + 1)/log 2, each database row's best vote
  counted once a query image, and each query's label log-likelihood
  against the leave-one-image-out prior (add-one smoothed), in f64.

``control=True`` computes each step one precision below the
configuration's: the vote and the refine solve in f32 (for f64), the ratio
test's distances and the Hough vote's inputs rounded to bf16 (for its f32
elementwise work).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from reference.keyparse import read_key

EIG_THRESHOLD = 140.0
REORIENT = 0x20
MAX_MATCHES = 3000
RATIO_LOG_SCALE = math.log(1.5)
RATIO_SHIFT = 0.5
HOUGH_SCALE, HOUGH_TRANS, HOUGH_ORIEN = 1.0, 2.0, 0.7
ETA = 1.0
f32 = np.float32


def read_set(path: str) -> dict:
    """A .key file's rows that pass the eigenvalue test and are reoriented."""
    s = read_key(path)
    e = s["eigs"]
    t = e.sum(1, dtype=f32)
    keep = (t * t * t < f32(EIG_THRESHOLD) * e.prod(1, dtype=f32)) & ((s["info"] & REORIENT) != 0)
    return {k: v[keep] for k, v in s.items()}


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bfloat16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, f32)).to(torch.bfloat16).float().numpy()


def dist_sqr(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """[Q, D] squared L2 distances of integer descriptor rows (exact in
    f64)."""
    q, d = q.astype(np.float64), d.astype(np.float64)
    return np.maximum((q * q).sum(1)[:, None] + (d * d).sum(1)[None, :] - 2.0 * (q @ d.T), 0.0)


def compatible(db: dict, j: int, i: np.ndarray) -> np.ndarray:
    """compatible_features(db[j], db[i]) for a vector of rows i."""
    v = db["xyz"][j][None, :] - db["xyz"][i]
    dist = np.sqrt((v * v).sum(1))
    sdiff = np.abs(np.log(db["scale"][j] / db["scale"][i]))
    return (sdiff < RATIO_LOG_SCALE) & (dist < RATIO_SHIFT * db["scale"][j])


def ratio_test(queries: dict, db: dict, control: bool = False) -> dict:
    """{query_idx, db_idx, ratio} of every query row against db."""
    d = dist_sqr(queries["desc"], db["desc"]).astype(f32)
    if control:
        d = bf16(d)
    nq, nd = d.shape
    if nd < 2 or nq == 0:
        return dict(query_idx=np.zeros(0, np.int64), db_idx=np.zeros(0, np.int64), ratio=np.zeros(0, f32))
    swap = d[:, 1] < d[:, 0]
    m1 = np.where(swap, d[:, 1], d[:, 0])
    m2 = np.where(swap, d[:, 0], d[:, 1])
    i1 = swap.astype(np.int64)
    for j in range(2, nd):
        dj = d[:, j]
        lt1, lt2 = dj < m1, dj < m2
        apart = ~compatible(db, j, i1)
        m2 = np.where(lt1 & apart, m1, np.where(lt2 & ~lt1 & apart, dj, m2))
        m1 = np.where(lt1, dj, m1)
        i1 = np.where(lt1, j, i1)
    ratio = np.where(m2 > 0, m1 / np.where(m2 > 0, m2, f32(1.0)), f32(0.0)).astype(f32)
    return dict(query_idx=np.arange(nq, dtype=np.int64), db_idx=i1, ratio=ratio)


def _unit(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return (v / np.where(n > 0, n, f32(1.0))).astype(f32)


def frames(ori: np.ndarray) -> np.ndarray:
    """Orthonormal frame rows from the triangle of a feature's three
    orientation rows."""
    v12 = _unit(ori[:, 1] - ori[:, 0])
    v13 = _unit(ori[:, 2] - ori[:, 0])
    n = _unit(np.cross(v12, v13))
    return np.stack([v12, _unit(np.cross(n, v12)), n], 1)


def perimeter(ori: np.ndarray, s: np.ndarray) -> np.ndarray:
    d = lambda a, b: np.linalg.norm(ori[:, a] - ori[:, b], axis=-1)  # noqa: E731
    return (s * (d(0, 1) + d(0, 2) + d(1, 2))).astype(f32)


def hough_ok(rot, scale, p0, p1, pts0, pts1, s0, s1, o0, o1) -> np.ndarray:
    """[H, M] whether match m is an inlier of hypothesis h."""
    h, m = len(rot), len(pts0)
    proj = np.matmul(pts0[None] - p0[:, None], rot.transpose(0, 2, 1)) * scale[:, None, None] + p1[:, None]
    e = pts1[None] - proj
    ok = np.sqrt((e * e).sum(-1)) < HOUGH_TRANS * s1[None]
    ok &= np.abs(np.log(s1[None] / np.maximum(s0[None] * scale[:, None], f32(1e-20)))) < HOUGH_SCALE
    # cosine of orientation row k: o1_k . (rot o0_k) = (o1_k rot) . o0_k
    b = np.matmul(o1.reshape(1, m * 3, 3), rot).reshape(h, m, 3, 3)
    ok &= HOUGH_ORIEN < (b * o0[None]).sum(-1).min(-1)
    return ok


def umeyama(p: np.ndarray, q: np.ndarray, dtype) -> tuple:
    """(scale, rot, trans) minimising sum |s R p + t - q|^2."""
    p, q = p.astype(dtype), q.astype(dtype)
    pbar, qbar = p.mean(0), q.mean(0)
    cov = (q - qbar).T @ (p - pbar) / len(p)
    varp = ((p - pbar) ** 2).sum(1).mean()
    u, s, vt = np.linalg.svd(cov)
    diag = np.array([1.0, 1.0, np.sign(np.linalg.det(u) * np.linalg.det(vt))], dtype)
    rot = (u * diag[None]) @ vt
    scale = (s * diag).sum() / varp
    return float(scale), rot.astype(np.float64), (qbar - scale * (rot @ pbar)).astype(np.float64)


def match_pair(model: dict, inp: dict, rm: dict, control: bool = False) -> dict:
    """One pair's matches, inliers and refined transform (model -> input)."""
    lo = bf16 if control else (lambda a: a)
    order = np.argsort(rm["ratio"], kind="stable")[:MAX_MATCHES]
    mi, ii = rm["query_idx"][order], rm["db_idx"][order]
    out = dict(model_idx=mi, input_idx=ii, inlier=np.zeros(len(mi), bool), num_inliers=len(mi),
               scale=1.0, rot=np.eye(3), trans=np.zeros(3))
    if len(mi) <= 3:
        return out
    pts0, pts1 = lo(model["xyz"][mi]), lo(inp["xyz"][ii])
    s0, s1 = lo(model["scale"][mi]), lo(inp["scale"][ii])
    o0, o1 = lo(model["ori"][mi]), lo(inp["ori"][ii])
    rots = np.einsum("mki,mkj->mij", frames(o1), frames(o0)).astype(f32)
    scales = (perimeter(o1, s1) / np.maximum(perimeter(o0, s0), f32(1e-20))).astype(f32)
    scores = np.concatenate([
        hough_ok(rots[h : h + 128], scales[h : h + 128], pts0[h : h + 128], pts1[h : h + 128],
                 pts0, pts1, s0, s1, o0, o1).sum(1)
        for h in range(0, len(mi), 128)])
    best = int(np.argmax(scores))
    inl = hough_ok(rots[best : best + 1], scales[best : best + 1], pts0[best : best + 1], pts1[best : best + 1],
                   pts0, pts1, s0, s1, o0, o1)[0]
    rot, scale = rots[best].astype(np.float64), float(scales[best])
    centre0 = 0.5 * (model["xyz"].min(0) + model["xyz"].max(0))
    centre1 = (rot @ (centre0 - pts0[best])) * scale + pts1[best]
    out.update(inlier=inl, num_inliers=int(inl.sum()), scale=scale, rot=rot, trans=centre1 - scale * (rot @ centre0))
    if inl.sum() >= 4:
        out["scale"], out["rot"], out["trans"] = umeyama(pts0[inl], pts1[inl], np.float32 if control else np.float64)
    return out


def knn(db: np.ndarray, k: int) -> tuple:
    """(squared distances, rows) of each row's k nearest rows of db, in
    ascending (distance, row) order."""
    t = torch.from_numpy(db.astype(np.float32))
    norms = (t * t).sum(1)
    dists, rows = [], []
    for s in range(0, len(t), 2048):
        q = t[s : s + 2048]
        d2 = torch.clamp(norms[s : s + 2048, None] + norms[None] - 2.0 * (q @ t.T), min=0.0)  # exact: integers
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
        r, c = torch.nonzero(d2 <= kth, as_tuple=True)
        v = d2[r, c].numpy()
        r, c = r.numpy(), c.numpy()
        o = np.lexsort((c, v, r))
        r, c, v = r[o], c[o], v[o]
        first = np.searchsorted(r, np.arange(len(q)))
        take = (first[:, None] + np.arange(k)[None]).ravel()
        rows.append(c[take].reshape(len(q), k))
        dists.append(v[take].reshape(len(q), k))
    return np.concatenate(dists), np.concatenate(rows)


def group_vote(sets: Sequence[dict], k: int, dtype) -> dict:
    """{votes, counts, log_likelihood} [n_img, n_img] of the soft vote,
    each set its own label, computed in `dtype`."""
    n_img = len(sets)
    sizes = np.array([len(s["xyz"]) for s in sets])
    db = np.concatenate([s["desc"] for s in sets])
    img = np.repeat(np.arange(n_img), sizes)
    total = len(db)
    k = min(k, total)
    votes = np.zeros((n_img, n_img), dtype)
    counts = np.zeros((n_img, n_img), np.int64)
    ll = np.zeros((n_img, n_img), dtype)
    if k == 0:
        return dict(votes=votes, counts=counts, log_likelihood=ll)
    dist, idx = knn(db, k)
    prior0 = (np.bincount(img, minlength=n_img) + 1.0) / (total + n_img)
    one, eta = dtype(1.0), dtype(ETA)
    start = 0
    for q_img in range(n_img):
        prior = prior0.astype(dtype)
        prior[q_img] -= dtype(sizes[q_img] / (total + n_img))
        best = {}
        for qi in range(start, start + sizes[q_img]):
            seen, acc, acc_d = set(), [], []
            for j in range(k):
                fi = int(idx[qi, j])
                if img[fi] == q_img or img[fi] in seen:
                    continue
                seen.add(img[fi])
                acc.append(fi)
                acc_d.append(dist[qi, j])
            if not acc:
                continue
            d = np.asarray(acc_d, dtype)
            pos = d[d > 0]
            dmin = pos.min() if len(pos) else one
            w = np.exp(-((d / dmin) ** 2))
            if w.sum() <= 0:
                continue
            w = np.log(w / w.sum() + eta) / np.log(eta + one)
            lcount = prior.copy()
            for j, fi in enumerate(acc):
                lab = img[fi]
                e = d[j] / (dmin + one)
                lcount[lab] += np.exp(-e * e) / prior[lab]
                prev = best.get(fi)
                if prev is None:
                    votes[q_img, lab] += w[j]
                    counts[q_img, lab] += 1
                    best[fi] = w[j]
                elif w[j] > prev:
                    if prev > 0:
                        votes[q_img, lab] -= prev
                    votes[q_img, lab] += w[j]
                    best[fi] = w[j]
            ll[q_img] += np.log(lcount / lcount.sum())
        start += sizes[q_img]
    return dict(votes=votes.astype(np.float64), counts=counts, log_likelihood=ll.astype(np.float64))


def group(paths: Sequence[str], neighbors: int, control: bool = False) -> dict:
    """The group call's outputs: the read sets, every pair's ratio test
    and match (set i against set 0) and the group vote."""
    sets = [read_set(p) for p in paths]
    ratio = [ratio_test(s, sets[0], control) for s in sets[1:]]
    pairs = [match_pair(s, sets[0], r, control) for s, r in zip(sets[1:], ratio)]
    vote = group_vote(sets, neighbors, np.float32 if control else np.float64)
    return dict(sets=sets, ratio=ratio, pairs=pairs, vote=vote)
