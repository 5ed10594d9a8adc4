"""Hough similarity-transform voting.

Port of determine_similarity_transform_hough
(feat_common/featMatchUtilities.cpp:816-1025), the counterpart of
``sift3d.match.hough``: every putative match is a transform hypothesis —
three virtual points built from (location, orientation, scale)
(feature_to_three_points :776-814), a closed-form 3-point similarity solve
(determine_similarity_transform_3point :704-773 via orthonormal triangle
frames), and an inlier count over all matches under the HOUGH_THRES_*
rules (:918-937). The best hypothesis has the most inliers, the first on
ties (strict '>' update, :941).

The frames and scales (:func:`hypotheses`) carry the fma contractions
XLA's CPU code makes in the JAX package (each norm's sum of squares and each
dot an fma chain, each cross-product term fma(a, b, -(c d)),
``numerics.fma_exact``), so the winning rotation and scale, and with them
the transform files, are the JAX package's bit for bit. The kernel M3
(``csrc/hough_scores.cu``) forms them itself, each hypothesis in the
registers of the threads that score it (``__fmaf_rn`` for ``fma_exact``,
``__fsqrt_rn`` for ``numerics.sqrt``), from the matches alone: no rotation
or scale is computed on the host or uploaded. It scores a stack of pairs,
each hypothesis against the matches of its own pair (segment):
:func:`hough_scores`, whose plain version forms the hypotheses with
:func:`hypotheses` and runs :func:`hough_ok` over chunks of each segment's
hypotheses, then the winners' inlier masks and their rotations and scales,
:func:`hough_inliers`, whose plain version is :func:`hough_ok` on each
winner's row; the featmatch CLI runs every pair of a call as one stack
(:func:`hough_similarity_stacked`: two launches), and a single pair is a
stack of one. There every dot product is an explicit ((a0 b0 + a1 b1) +
a2 b2), every norm the correctly rounded root of such a sum, every log
computed in f64 and rounded to f32, in the kernel and here alike. The JAX
package sums a probability per match that its caller sets to ones, so its
score is this count; it pads M to a power of two for XLA, the port does
not.
"""

from __future__ import annotations

import numpy as np
import torch

from sift3d_torch.core import numerics
from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.utils.timing import TRACER

PLAIN_CHUNK = 1 << 20  # hypothesis-match pairs per chunk of the plain scorer
HOUGH_THREADS = 128  # hypotheses (scores) or matches (inliers) a block of M3 (hough_scores.cu kThreads)
HOUGH_CHUNK = 128  # matches a scores block of M3 (kChunk)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _dot3_fma(a, b):
    return fma_exact(a[..., 2], b[..., 2], fma_exact(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _normalize(v):
    n = numerics.sqrt(_dot3_fma(v, v))[..., None]
    return v / torch.where(n > 0, n, torch.ones_like(n))


def _cross(a, b):
    def term(i, j):  # a_i b_j - a_j b_i
        return fma_exact(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([term(1, 2), term(2, 0), term(0, 1)], dim=-1)


def triangle_frame(ori):
    """Orthonormal frame rows from a feature's triangle of virtual points.

    determine_rotation_3point on points P_k = loc + s * ori_row_k: the
    location and scale cancel, leaving a frame built from the ori rows."""
    v12 = _normalize(ori[..., 1, :] - ori[..., 0, :])
    v13 = _normalize(ori[..., 2, :] - ori[..., 0, :])
    n = _normalize(_cross(v12, v13))
    third = _normalize(_cross(n, v12))
    return torch.stack([v12, third, n], dim=-2)  # rows


def triangle_perimeter(ori, s):
    """Sum of pairwise distances of the 3 virtual points (scale factor)."""

    def dist(a, b):
        e = ori[..., a, :] - ori[..., b, :]
        return numerics.sqrt(_dot3_fma(e, e))

    return s * ((dist(0, 1) + dist(0, 2)) + dist(1, 2))


def hypotheses(s0, s1, o0, o1):
    """(rots [M, 3, 3], scales [M]) of every match as a hypothesis: rot =
    R1^T R0 of the two triangle frames (determine_similarity_transform_3point
    :760-770), scale = the ratio of the triangles' perimeters."""
    r0 = triangle_frame(o0)
    r1 = triangle_frame(o1)
    rots = torch.stack(
        [torch.stack([_dot3_fma(r1[:, :, i], r0[:, :, j]) for j in range(3)], dim=-1) for i in range(3)], dim=-2
    )
    p0 = triangle_perimeter(o0, s0)
    scales = triangle_perimeter(o1, s1) / torch.maximum(p0, torch.full_like(p0, 1e-20))
    return rots, scales


def hough_ok(rot, scale, h0, h1, pts0, pts1, s0, s1, o0, o1, thresholds):
    """[H, M] bool: match j is an inlier of hypothesis h (rot [H, 3, 3],
    scale [H], pair (h0, h1) [H, 3]) under the thresholds (scale, trans,
    orien), each an f32 value."""
    thres_scale, thres_trans, thres_orien = thresholds
    diff = pts0[None] - h0[:, None]  # [H, M, 3]
    rows = rot[:, None]  # [H, 1, 3, 3]
    proj = torch.stack([_dot3(rows[..., i, :], diff) for i in range(3)], dim=-1) * scale[:, None, None] + h1[:, None]
    e = pts1[None] - proj
    ok = numerics.sqrt(_dot3(e, e)) < thres_trans * s1[None]
    # orientation: the min row-cosine between o1_j and R o0_j rows
    cos = []
    for k in range(3):
        ro = torch.stack([_dot3(rows[..., i, :], o0[None, :, k]) for i in range(3)], dim=-1)
        cos.append(_dot3(ro, o1[None, :, k]))
    mincos = torch.minimum(torch.minimum(cos[0], cos[1]), cos[2])
    ok &= thres_orien < mincos
    ts = s0[None] * scale[:, None]
    ratio = s1[None] / torch.maximum(ts, torch.full_like(ts, 1e-20))
    ok &= torch.log(ratio.double()).float().abs() < thres_scale
    return ok


def segment_offsets(sizes) -> np.ndarray:
    """[P + 1] int64 offsets of P segments of the given sizes, stacked."""
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))]).astype(np.int64)


def segment_blocks(offsets, inliers: bool = False) -> np.ndarray:
    """[P + 1] int32 offsets of each segment's blocks in M3's grid: for the
    scores ceil(M_p / HOUGH_THREADS) hypothesis tiles by ceil(M_p /
    HOUGH_CHUNK) match chunks, for the inlier masks ceil(M_p /
    HOUGH_THREADS) match tiles; an empty segment has none."""
    m = np.diff(np.asarray(offsets, np.int64))
    tiles = -(-m // HOUGH_THREADS)
    per = tiles if inliers else tiles * -(-m // HOUGH_CHUNK)
    return np.concatenate([[0], np.cumsum(per)]).astype(np.int32)


def _segments(offsets, m: int):
    offsets = [0, m] if offsets is None else [int(o) for o in offsets]
    return list(zip(offsets[:-1], offsets[1:]))


def hough_scores_plain(pts0, pts1, s0, s1, o0, o1, thresholds, offsets=None):
    """[M] int32 inlier counts of every match as a hypothesis (:func:`hypotheses`)
    against the matches of its own segment (offsets [P + 1]; None: one
    segment), in chunks of hypotheses."""
    rots, scales = hypotheses(s0, s1, o0, o1)
    out = []
    for lo, hi in _segments(offsets, pts0.shape[0]):
        seg = slice(lo, hi)
        args = (pts0[seg], pts1[seg], s0[seg], s1[seg], o0[seg], o1[seg])
        step = max(1, PLAIN_CHUNK // max(hi - lo, 1))
        out += [
            hough_ok(rots[h : min(h + step, hi)], scales[h : min(h + step, hi)], pts0[h : min(h + step, hi)],
                     pts1[h : min(h + step, hi)], *args, thresholds).sum(dim=1, dtype=torch.int32)
            for h in range(lo, hi, step)
        ]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=pts0.device)


def hough_inliers_plain(pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners):
    """([M] bool, [P, 10] f32): each segment's matches that are inliers of
    its winning hypothesis (winners [P], rows of the stack), hough_ok on the
    winner's row; and each winner's rotation (row-major) and scale
    (:func:`hypotheses` on the winners' rows), zeros for an empty segment."""
    segs = _segments(offsets, pts0.shape[0])
    mask = torch.zeros(pts0.shape[0], dtype=torch.bool, device=pts0.device)
    rs = torch.zeros(len(segs), 10, dtype=torch.float32, device=pts0.device)
    live = [(p, lo, hi, int(w)) for p, ((lo, hi), w) in enumerate(zip(segs, winners)) if hi > lo]
    if not live:
        return mask, rs
    rows = torch.tensor([w for *_, w in live], device=pts0.device)
    rots, scales = hypotheses(s0[rows], s1[rows], o0[rows], o1[rows])
    for k, (_, lo, hi, w) in enumerate(live):
        mask[lo:hi] = hough_ok(rots[k][None], scales[k][None], pts0[w][None], pts1[w][None], pts0[lo:hi],
                               pts1[lo:hi], s0[lo:hi], s1[lo:hi], o0[lo:hi], o1[lo:hi], thresholds)[0]
    rs[[p for p, *_ in live]] = torch.cat([rots.reshape(-1, 9), scales[:, None]], dim=1)
    return mask, rs


def _launch(mode: int, pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners, scores, mask, winner_rs):
    """One launch of M3 in `mode` over the stack's segments; none when
    every segment is empty (no block to launch)."""
    m = pts0.shape[0]
    for name, t, shape in (
        ("pts0", pts0, (m, 3)), ("pts1", pts1, (m, 3)), ("s0", s0, (m,)), ("s1", s1, (m,)),
        ("o0", o0, (m, 3, 3)), ("o1", o1, (m, 3, 3)),
    ):
        cuda_lib.require_cuda(t, name, torch.float32, len(shape))
        if tuple(t.shape) != shape or t.device != pts0.device:
            raise ValueError(f"{name} must be {shape} on {pts0.device}, got {tuple(t.shape)} on {t.device}")
    offsets = np.asarray([0, m] if offsets is None else offsets, np.int64)
    if offsets[0] != 0 or offsets[-1] != m or (np.diff(offsets) < 0).any():
        raise ValueError(f"offsets must ascend from 0 to {m}, got {offsets.tolist()}")
    blocks = segment_blocks(offsets, inliers=mode == 1)
    if blocks[-1] == 0:
        return
    p = len(offsets) - 1
    tables = (None, None, None)  # one pair: its count and winner are arguments
    if p > 1:
        # offsets, block offsets and winners in one copy; from pageable memory
        # a non-blocking copy is staged at once, without waiting on the card
        meta = np.concatenate([offsets, blocks, [] if winners is None else winners]).astype(np.int32)
        meta = torch.from_numpy(meta).to(pts0.device, non_blocking=True)
        tables = (meta, meta[p + 1 :], None if winners is None else meta[2 * p + 2 :])
    winner = int(winners[0]) if winners is not None and p == 1 else 0
    cuda_lib.launch("sift3d_hough", mode, pts0, pts1, s0, s1, o0, o1, *tables, scores, mask, winner_rs, p, m,
                    winner, int(blocks[-1]), *thresholds, device=pts0.device)


def hough_scores(pts0, pts1, s0, s1, o0, o1, thresholds, offsets=None):
    """M3's scores (see hough_scores_plain): the plain version for CPU
    tensors, one launch of the kernel over every segment for CUDA tensors,
    which forms the M hypotheses on the card and counts them
    (``card_hypotheses``)."""
    if cuda_lib.route(pts0) == "plain":
        return hough_scores_plain(pts0, pts1, s0, s1, o0, o1, thresholds, offsets)
    scores = torch.zeros(pts0.shape[0], dtype=torch.int32, device=pts0.device)
    if pts0.shape[0] == 0:
        return scores
    TRACER.count("card_hypotheses", pts0.shape[0])
    _launch(0, pts0, pts1, s0, s1, o0, o1, thresholds, offsets, None, scores, None, None)
    return scores


def _mask_bytes(m: int) -> int:
    """Bytes of the mask in M3's inlier output: m, rounded up to whole
    floats, so the winners' rotations and scales after it are aligned."""
    return -(-m // 4) * 4


def _inliers_packed(pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners):
    """M3's inlier output as one uint8 buffer: the [M] mask, then (at
    _mask_bytes(M)) the [P, 10] f32 winners' rotations and scales, so one
    copy brings both to the host (:func:`_unpack_inliers`)."""
    m = pts0.shape[0]
    p = 1 if offsets is None else len(offsets) - 1
    if cuda_lib.route(pts0) == "plain":
        mask, rs = hough_inliers_plain(pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners)
        pad = torch.zeros(_mask_bytes(m) - m, dtype=torch.uint8, device=pts0.device)
        return torch.cat([mask.view(torch.uint8), pad, rs.reshape(-1).view(torch.uint8)])
    out = torch.zeros(_mask_bytes(m) + 40 * p, dtype=torch.uint8, device=pts0.device)
    mask, rs = _unpack_inliers(out, m, p)
    if m:
        _launch(1, pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners, None, mask, rs)
    return out


def _unpack_inliers(packed, m: int, p: int):
    """(mask [M] bool, winners' rotations and scales [P, 10] f32): views of
    an :func:`_inliers_packed` buffer."""
    return packed[:m].view(torch.bool), packed[_mask_bytes(m) :].view(torch.float32).view(p, 10)


def hough_inliers(pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners):
    """M3's inlier masks and the winners' rotations and scales (see
    hough_inliers_plain): the plain version for CPU tensors, one launch of
    the kernel's second mode for CUDA tensors, which forms each winner on
    the card."""
    p = 1 if offsets is None else len(offsets) - 1
    return _unpack_inliers(_inliers_packed(pts0, pts1, s0, s1, o0, o1, thresholds, offsets, winners),
                           pts0.shape[0], p)


def hough_similarity_stacked(pairs, cfg: SiftConfig = DEFAULT_CONFIG, device=None):
    """hough_similarity of every pair of a list, each (pts0, pts1, s0, s1,
    o0, o1) of M_p >= 1 matches as numpy arrays or tensors: the matches
    stacked on the host, ONE launch of M3's scores over every pair (which
    forms the hypotheses on the card), each pair's first maximum from one
    copy to the host, ONE launch of its inlier masks, which also returns the
    winners' rotations and scales in the mask's copy. Returns a
    hough_similarity dict per pair. device: None means the card (raises
    without one); "cpu" runs M3's plain versions. Spans
    (``utils.timing.TRACER``): hough_hypotheses (the stacking), hough_vote
    (the uploads, M3 and its copies, the maxima)."""
    if not pairs:
        return []
    dev = resolve_device(device, like=pairs[0][0])
    shapes = ((3,), (3,), (), (), (3, 3), (3, 3))
    with TRACER.stage("hough_hypotheses"):
        host = [torch.cat([torch.as_tensor(p[f], dtype=torch.float32, device="cpu").reshape(-1, *shape)
                           for p in pairs])
                for f, shape in enumerate(shapes)]
    with TRACER.stage("hough_vote"):
        matches = [t.to(dev).contiguous() for t in host]
        thresholds = tuple(
            float(np.float32(t)) for t in (cfg.hough_thres_scale, cfg.hough_thres_trans, cfg.hough_thres_orien)
        )
        offsets = segment_offsets([len(p[0]) for p in pairs])
        scores = hough_scores(*matches, thresholds, offsets).cpu().numpy()
        bounds = list(zip(offsets[:-1].tolist(), offsets[1:].tolist()))
        winners = [lo + int(np.argmax(scores[lo:hi])) for lo, hi in bounds]  # the first maxima
        packed = _inliers_packed(*matches, thresholds, offsets, winners).cpu()
        inliers, rs = (t.numpy() for t in _unpack_inliers(packed, int(offsets[-1]), len(pairs)))
    return [
        dict(hypothesis=w - lo, rot=rs[p, :9].reshape(3, 3).astype(np.float64), scale=float(rs[p, 9]),
             inliers=inliers[lo:hi], score=float(scores[w]))
        for p, ((lo, hi), w) in enumerate(zip(bounds, winners))
    ]


def hough_similarity(pts0, pts1, s0, s1, o0, o1, cfg: SiftConfig = DEFAULT_CONFIG, device=None):
    """Returns dict(hypothesis, rot [3,3] f64, scale, inliers [M] bool,
    score) for M >= 1 matches given as numpy arrays or tensors: the stack of
    one pair (hough_similarity_stacked). device: None means the card
    (raises without one); "cpu" runs M3's plain versions."""
    return hough_similarity_stacked([(pts0, pts1, s0, s1, o0, o1)], cfg, device)[0]
