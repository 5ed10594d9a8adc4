"""Pairwise matching: NN + ratio test with geometric-compatibility shuffle.

Port of msComputeNearestNeighborDistanceRatioInfo
(feat_common/featMatchUtilities.cpp:336-421) and the match-list assembly of
MatchKeys (:1027-1136), the counterpart of ``sift3d.match.pairwise``. The
descriptor distance is L2 over the 64 rank-ordered values (the reference
snapshot has it commented out, SURVEY.md section 2.3 quirk 2; the JAX
package implements the intent).

The reference walks the database sequentially per query, keeping a (1st,
2nd)-nearest state with geometric-compatibility shuffling. The kernel M2
(:func:`ratio_rows`, ``csrc/ratio_match.cu``) computes that state machine,
each distance row on the fly, on one of two routes chosen from the data as
M1's are (``knn_cuda.int8_route``): int8-range integer rows (every ``.key``
descriptor) take :func:`ratio_rows_int8`, the distances on the int8 tensor
cores and the database cut into segments walked in parallel
(:func:`ratio_rows_split_plain` is the plain form of that cut); other rows
take :func:`ratio_rows_f32`, one query a thread on f32 chains. Its plain
version (:func:`ratio_rows_plain`) is the JAX package's closed form of the
same machine over the [Q, D] distance matrix:

  min1 = global minimum (earliest index on ties);
  min2 = min over the "displacement events" of the scan —
    E0: the non-minimum of the first database pair (set unconditionally);
    E1: at each strict prefix-minimum transition j, the OLD minimum's
        distance, iff j is incompatible with that old minimum;
    E2: every non-record j >= 2 contributes its own distance iff j is
        incompatible with the prefix minimum current at j.

Both take distances in M1's order (``knn_cuda.dist_sqr_plain``) and the
compatibility test of :func:`compatible_features`, so they agree to the
bit; the CPU tests hold the plain version to the JAX ``ratio_match`` and
its sequential oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sift3d_torch.core import numerics
from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.knn_cuda import INT8_TILE, dist_sqr_plain, int8_route, sq_norms
from sift3d_torch.utils.timing import TRACER

PLAIN_CHUNK = 1 << 22  # distances per chunk of the plain version's compatibility gather
RATIO_SEGMENT = 16  # database rows a segment of the int8 kernel walks (ratio_match.cu kSeg)


def compatible_features(xyz_a, scale_a, xyz_b, scale_b, log_thr: float, shift: float) -> torch.Tensor:
    """compatible_features (featMatchUtilities.cpp:60-158, sphere case):
    |log(s_a / s_b)| < log_thr and |xyz_a - xyz_b| < shift * s_a.
    Asymmetric: the shift threshold is scaled by feature A's scale. The
    distance is the correctly rounded root of ((dx dx + dy dy) + dz dz), the
    log is computed in f64 and rounded to f32, as in the kernel."""
    e = xyz_a - xyz_b
    dist = numerics.sqrt((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2])
    sdiff = torch.log((scale_a / scale_b).double()).float().abs()
    return (sdiff < log_thr) & (dist < shift * scale_a)


def closed_form(d, xyz, scale, log_thr: float, shift: float):
    """The ratio test on distance rows d [q, D] (D >= 2) of a database at
    xyz [D, 3], scale [D]: (nearest index [q] int64, d1 / d2 [q] f32)."""
    cols = torch.arange(d.shape[1], device=d.device)
    # prefix-minimum records: is_rec[j] iff d[j] < min(d[:j]) (strict, so
    # the init-pair tie keeping index 0 falls out naturally)
    run_min = torch.cummin(d, dim=1).values
    is_rec = torch.ones_like(d, dtype=torch.bool)
    is_rec[:, 1:] = d[:, 1:] < run_min[:, :-1]
    # rec_pos[j] = index of the prefix minimum over d[:j+1]
    rec_pos = torch.cummax(torch.where(is_rec, cols, 0), dim=1).values
    m1_idx = rec_pos[:, -1]  # the earliest global minimum
    d1 = d.gather(1, m1_idx[:, None])[:, 0]
    # E0: the non-minimum of the first pair
    d2 = torch.where(d[:, 1] < d[:, 0], d[:, 0], d[:, 1])
    if d.shape[1] > 2:
        # events at j >= 2: partner = the prefix minimum before j; value =
        # the displaced old minimum (record j) or j's own distance
        partner = rec_pos[:, 1:-1]
        val = torch.where(is_rec[:, 2:], d.gather(1, partner), d[:, 2:])
        cmp = compatible_features(xyz[None, 2:], scale[None, 2:], xyz[partner], scale[partner], log_thr, shift)
        ev = torch.where(cmp, torch.full_like(val, torch.inf), val)
        d2 = torch.minimum(d2, ev.amin(dim=1))
    ratio = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, torch.ones_like(d2)), torch.zeros_like(d2))
    return m1_idx, ratio


def ratio_rows_plain(q, db, xyz, scale, log_thr: float, shift: float):
    """q [Q, 64], db [D, 64], xyz [D, 3], scale [D] f32, D >= 2 ->
    (nearest index [Q] int64, d1 / d2 [Q] f32): the closed form over M1's
    distance rows, in chunks of queries."""
    dn = sq_norms(db)
    step = max(1, PLAIN_CHUNK // db.shape[0])
    out = [closed_form(dist_sqr_plain(q[q0 : q0 + step], db, dn), xyz, scale, log_thr, shift)
           for q0 in range(0, q.shape[0], step)]
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=q.device), torch.zeros(0, device=q.device)
    return torch.cat([i for i, _ in out]), torch.cat([r for _, r in out])


def ratio_rows_split_plain(q, db, xyz, scale, log_thr: float, shift: float, seg_rows: int = RATIO_SEGMENT):
    """ratio_rows_plain with the database cut as the int8 kernel cuts it:
    segments of seg_rows rows; each segment's minimum (the earliest on
    ties), an exclusive scan over the segments for the prefix minimum that
    enters each, each segment's walk from that state (its rows' events: a
    record displaces the state's distance, any other row offers its own;
    row 1's counts always, a later row's when it is incompatible with the
    state's row), then the smallest counted event of all segments. Keys
    (distance bits << 32 | index) order like (distance, index), so a
    minimum of keys is the earliest minimum. Equal to ratio_rows_plain."""
    nq, nd = q.shape[0], db.shape[0]
    if nd < 2 or seg_rows < 1:
        raise ValueError(f"need >= 2 database rows and segments of >= 1 row, got {nd} and {seg_rows}")
    none = torch.iinfo(torch.int64).max
    nseg = -(-nd // seg_rows)
    index = torch.arange(nd, device=q.device)
    d = dist_sqr_plain(q, db, sq_norms(db))
    # distances are >= +0, so their bits order like their values
    key = (d.view(torch.int32).to(torch.int64) << 32) | index

    def shift_in(x):  # x moved one place along its last axis, `none` first (torch's pad goes through a float)
        return torch.cat([torch.full_like(x[..., :1], none), x[..., :-1]], dim=-1)

    key = torch.cat([key, torch.full((nq, nseg * seg_rows - nd), none, device=q.device)], dim=1)
    key = key.reshape(nq, nseg, seg_rows)
    seg_min = key.amin(dim=2)
    enter = torch.cummin(shift_in(seg_min), dim=1).values
    # the state before each row: the entering state, then the segment's rows before it
    before = torch.minimum(enter[..., None], shift_in(torch.cummin(key, dim=2).values)).reshape(nq, -1)[:, :nd]
    key = key.reshape(nq, -1)[:, :nd]
    record = key < before
    partner = (before & 0xFFFFFFFF).clamp(max=nd - 1)  # row 0's state is none: no event there
    state_d = (before >> 32).to(torch.int32).view(torch.float32)
    val = torch.where(record, state_d, d)
    counted = torch.zeros_like(record)
    counted[:, 1] = True
    if nd > 2:
        counted[:, 2:] = ~compatible_features(xyz[None, 2:], scale[None, 2:], xyz[partner[:, 2:]],
                                              scale[partner[:, 2:]], log_thr, shift)
    d2 = torch.where(counted, val, torch.full_like(val, torch.inf)).amin(dim=1)
    m = seg_min.amin(dim=1)
    d1 = (m >> 32).to(torch.int32).view(torch.float32)
    ratio = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, torch.ones_like(d2)), torch.zeros_like(d2))
    return m & 0xFFFFFFFF, ratio


def _check(q, db, xyz, scale):
    nq, nd = q.shape[0], db.shape[0]
    for name, t, shape in (("q", q, (nq, 64)), ("db", db, (nd, 64)), ("xyz", xyz, (nd, 3)), ("scale", scale, (nd,))):
        cuda_lib.require_cuda(t, name, torch.float32, len(shape))
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name} must be {shape} on {q.device}, got {tuple(t.shape)} on {t.device}")


def _outputs(q):
    return (torch.empty(q.shape[0], dtype=torch.int64, device=q.device),
            torch.empty(q.shape[0], dtype=torch.float32, device=q.device))


def ratio_rows_f32(q, db, xyz, scale, log_thr: float, shift: float):
    """M2's f32 route (see ratio_rows_plain): the plain version for CPU
    tensors, the f32 kernel for CUDA tensors, any rows."""
    if db.shape[0] < 2:
        raise ValueError(f"the ratio test needs >= 2 database rows, got {db.shape[0]}")
    if cuda_lib.route(q) == "plain":
        return ratio_rows_plain(q, db, xyz, scale, log_thr, shift)
    _check(q, db, xyz, scale)
    idx, ratio = _outputs(q)
    if q.shape[0]:
        cuda_lib.launch("sift3d_ratio_match", q, db, xyz, scale, idx, ratio, q.shape[0], db.shape[0], log_thr, shift,
                        device=q.device)
    return idx, ratio


def ratio_rows_int8(q, db, xyz, scale, log_thr: float, shift: float):
    """M2's int8 route (see ratio_rows_plain), for rows whose 64 columns
    are integers in -128..127: raises ValueError for any others
    (knn_cuda.int8_route, checked here). The plain version for CPU tensors;
    for CUDA tensors M1's pre-pass and the int8 kernel, two launches."""
    if db.shape[0] < 2:
        raise ValueError(f"the ratio test needs >= 2 database rows, got {db.shape[0]}")
    if not int8_route(q, db):
        raise ValueError("M2's int8 route takes rows whose 64 columns are integers in -128..127")
    return _int8(q, db, xyz, scale, log_thr, shift)


def _int8(q, db, xyz, scale, log_thr: float, shift: float):
    """ratio_rows_int8 on rows int8_route has passed."""
    if cuda_lib.route(q) == "plain":
        return ratio_rows_plain(q, db, xyz, scale, log_thr, shift)
    _check(q, db, xyz, scale)
    idx, ratio = _outputs(q)
    nq, nd = q.shape[0], db.shape[0]
    if nq == 0:
        return idx, ratio
    npad = -(-nd // INT8_TILE) * INT8_TILE
    db8 = torch.empty((npad, 16), dtype=torch.int32, device=q.device)
    dn = torch.empty(npad, dtype=torch.float32, device=q.device)
    cuda_lib.launch("sift3d_knn_prep_i8", db, db8, dn, None, nd, npad, 64, device=q.device)
    cuda_lib.launch("sift3d_ratio_match_i8", q, db8, dn, xyz, scale, idx, ratio, nq, nd, log_thr, shift,
                    device=q.device)
    return idx, ratio


def ratio_rows(q, db, xyz, scale, log_thr: float, shift: float):
    """M2 (see ratio_rows_plain): the plain version for CPU tensors; for
    CUDA tensors the int8 route where int8_route(q, db) holds, decided from
    the data, else the f32 route."""
    if db.shape[0] < 2:
        raise ValueError(f"the ratio test needs >= 2 database rows, got {db.shape[0]}")
    if cuda_lib.route(q) == "plain":
        return ratio_rows_plain(q, db, xyz, scale, log_thr, shift)
    route = _int8 if int8_route(q, db) else ratio_rows_f32  # each checks its arguments
    return route(q, db, xyz, scale, log_thr, shift)


@dataclasses.dataclass
class RatioMatches:
    query_idx: np.ndarray  # [M] indices into the query (model) set
    db_idx: np.ndarray  # [M] indices into the database (input) set
    ratio: np.ndarray  # [M] d1/d2


def _empty_matches() -> RatioMatches:
    return RatioMatches(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))


def ratio_match_stacked(query_sets, db: FeatureSet, cfg: SiftConfig = DEFAULT_CONFIG, device=None):
    """ratio_match of every query set against one database, as ONE M2
    launch over the concatenated queries, split back by each set's offset.
    Returns a RatioMatches per set (empty ones when the database has fewer
    than 2 rows)."""
    dev = resolve_device(device)
    if len(db) < 2:
        return [_empty_matches() for _ in query_sets]
    sizes = [len(s) for s in query_sets]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    q = np.concatenate([s.desc for s in query_sets]) if query_sets else np.zeros((0, 64), np.float32)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    idx, ratio = ratio_rows(
        put(q), put(db.desc), put(db.xyz), put(db.scale),
        float(np.float32(cfg.ratio_compat_log_scale)), float(cfg.ratio_compat_shift),
    )
    idx, ratio = idx.cpu().numpy(), ratio.cpu().numpy()
    return [
        RatioMatches(np.arange(n, dtype=np.int64), idx[o : o + n], ratio[o : o + n]) if n else _empty_matches()
        for n, o in zip(sizes, offsets)
    ]


def ratio_match(queries: FeatureSet, db: FeatureSet, cfg: SiftConfig = DEFAULT_CONFIG, device=None) -> RatioMatches:
    """For each query feature, the nearest db feature and the squared-
    distance ratio d1 / d2, with the reference's geometric-compatibility
    shuffle reproduced exactly. device: None means the card (raises without
    one); "cpu" runs M2's plain version."""
    return ratio_match_stacked([queries], db, cfg, device)[0]


@dataclasses.dataclass
class MatchResult:
    """MatchKeys outputs: inlier correspondences + similarity transform
    mapping query-set coordinates to db-set coordinates."""

    model_idx: np.ndarray  # indices into the query/model set (image 2)
    input_idx: np.ndarray  # indices into the db/input set (image 1)
    inlier: np.ndarray  # bool per match
    num_inliers: int
    transform: "object"  # SimilarityTransform (2 -> 1)


def match_keys_stacked(
    feats1: FeatureSet,
    query_sets,
    cfg: SiftConfig = DEFAULT_CONFIG,
    refine: bool = False,
    matches=None,
    device=None,
):
    """match_keys of every query set against one database feats1, as one
    stack: each pair's ratio-sorted matches capped at max_matches, then the
    Hough vote of every pair with more than 3 matches in ONE call of
    ``hough.hough_similarity_stacked`` (two launches of M3), then each
    pair's transform and its --refine solve. `matches` optionally supplies
    ratio_match_stacked(query_sets, feats1) (else one M2 launch computes it).
    Returns a MatchResult per query set, each equal to match_keys on it
    alone. device: None means the card (raises without one); "cpu" runs the
    plain versions. Spans (``utils.timing.TRACER``): hough_cap (the sort,
    the cap and the voted pairs' rows), hough_hypotheses and hough_vote
    (in ``hough_similarity_stacked``), refine (the transforms and solves)."""
    from sift3d_torch.match.hough import hough_similarity_stacked
    from sift3d_torch.match.register import SimilarityTransform
    from sift3d_torch.match.solve import solve_similarity

    dev = resolve_device(device)
    if matches is None:
        matches = ratio_match_stacked(query_sets, feats1, cfg, dev)
    with TRACER.stage("hough_cap"):
        capped = []
        for rm in matches:
            order = np.argsort(rm.ratio, kind="stable")[: cfg.max_matches]
            capped.append((rm.query_idx[order], rm.db_idx[order]))
        voted = [i for i, (model_idx, _) in enumerate(capped) if model_idx.shape[0] > 3]
        rows = [
            (feats2.xyz[model_idx], feats1.xyz[input_idx], feats2.scale[model_idx], feats1.scale[input_idx],
             feats2.ori[model_idx], feats1.ori[input_idx])
            for feats2, (model_idx, input_idx) in ((query_sets[i], capped[i]) for i in voted)
        ]
    best_of = dict(zip(voted, hough_similarity_stacked(rows, cfg, dev)))

    results = []
    with TRACER.stage("refine"):
        for i, (feats2, (model_idx, input_idx)) in enumerate(zip(query_sets, capped)):
            if i not in best_of:
                results.append(MatchResult(
                    model_idx=model_idx,
                    input_idx=input_idx,
                    inlier=np.zeros(model_idx.shape[0], bool),
                    num_inliers=int(model_idx.shape[0]),
                    transform=SimilarityTransform(),
                ))
                continue
            best = best_of[i]
            # model center parameterizes the output transform
            # (getMinMaxDim midpoint, featMatchUtilities.cpp:1150-1160)
            center0 = 0.5 * (feats2.xyz.min(axis=0) + feats2.xyz.max(axis=0))
            rot = best["rot"]
            scale = best["scale"]
            h = best["hypothesis"]
            # translation: transform the model center (similarity_transform_3point
            # about the winning correspondence pair)
            c0 = feats2.xyz[model_idx[h]]
            c1 = feats1.xyz[input_idx[h]]
            center1 = (rot @ (center0 - c0)) * scale + c1
            # convert rotation-about-point to rotation-about-origin translation
            trans = center1 - scale * (rot @ center0)
            ts = SimilarityTransform(scale=float(scale), rot=rot, trans=trans)
            inl = best["inliers"]
            if refine and inl.sum() >= 4:
                # weighted least-squares (Umeyama) over the Hough inliers — a
                # refinement step the reference lacks (it keeps the single winning
                # hypothesis); markedly tightens the transform on noisy data
                s, r, t = solve_similarity(feats2.xyz[model_idx[inl]], feats1.xyz[input_idx[inl]], device=dev)
                ts = SimilarityTransform(scale=s, rot=r, trans=t)
            results.append(MatchResult(
                model_idx=model_idx,
                input_idx=input_idx,
                inlier=inl,
                num_inliers=int(inl.sum()),
                transform=ts,
            ))
    return results


def match_keys(
    feats1: FeatureSet,
    feats2: FeatureSet,
    cfg: SiftConfig = DEFAULT_CONFIG,
    refine: bool = False,
    matches: Optional[RatioMatches] = None,
    device=None,
) -> MatchResult:
    """MatchKeys (featMatchUtilities.cpp:1027-1260): ratio-sorted matches
    capped at max_matches, then Hough similarity voting. feats2 is the
    'model' (queries), feats1 the 'input' (database), and the returned
    transform maps feats2 coordinates into feats1 space. `matches`
    optionally supplies ratio_match(feats2, feats1). The stack of one pair
    (match_keys_stacked). device: None means the card (raises without one);
    "cpu" runs the plain versions."""
    return match_keys_stacked(feats1, [feats2], cfg, refine, None if matches is None else [matches], device)[0]
