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

The frames and scales (:func:`hypotheses`) are plain torch over the M
matches, on the host: they carry the fma contractions XLA's CPU code makes
in the JAX package (each norm's sum of squares and each dot an fma chain,
each cross-product term fma(a, b, -(c d)), ``numerics.fma_exact``), so the
winning rotation and scale, and with them the transform files, are the JAX
package's bit for bit. The M x M scoring is the kernel M3
(:func:`hough_scores`, ``csrc/hough_scores.cu``), whose plain version runs
:func:`hough_ok` over chunks of hypotheses; the winner's inlier mask is
:func:`hough_ok` on its one row. There every dot product is an explicit
((a0 b0 + a1 b1) + a2 b2), every norm the correctly rounded root of such a
sum, every log computed in f64 and rounded to f32, in the kernel and here
alike. The JAX package sums a probability per match that its caller sets
to ones, so its score is this count; it pads M to a power of two for XLA,
the port does not.
"""

from __future__ import annotations

import numpy as np
import torch

from sift3d_torch.core import numerics
from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.kernels import cuda_lib

PLAIN_CHUNK = 1 << 20  # hypothesis-match pairs per chunk of the plain scorer


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


def hough_scores_plain(rots, scales, pts0, pts1, s0, s1, o0, o1, thresholds):
    """[M] int32 inlier counts of every hypothesis, in chunks of hypotheses."""
    m = pts0.shape[0]
    step = max(1, PLAIN_CHUNK // max(m, 1))
    out = [
        hough_ok(rots[h : h + step], scales[h : h + step], pts0[h : h + step], pts1[h : h + step],
                 pts0, pts1, s0, s1, o0, o1, thresholds).sum(dim=1, dtype=torch.int32)
        for h in range(0, m, step)
    ]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=pts0.device)


def hough_scores(rots, scales, pts0, pts1, s0, s1, o0, o1, thresholds):
    """M3 (see hough_scores_plain): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if cuda_lib.route(pts0) == "plain":
        return hough_scores_plain(rots, scales, pts0, pts1, s0, s1, o0, o1, thresholds)
    m = pts0.shape[0]
    for name, t, shape in (
        ("rots", rots, (m, 3, 3)), ("scales", scales, (m,)), ("pts0", pts0, (m, 3)), ("pts1", pts1, (m, 3)),
        ("s0", s0, (m,)), ("s1", s1, (m,)), ("o0", o0, (m, 3, 3)), ("o1", o1, (m, 3, 3)),
    ):
        cuda_lib.require_cuda(t, name, torch.float32, len(shape))
        if tuple(t.shape) != shape or t.device != pts0.device:
            raise ValueError(f"{name} must be {shape} on {pts0.device}, got {tuple(t.shape)} on {t.device}")
    scores = torch.zeros(m, dtype=torch.int32, device=pts0.device)
    if m == 0:
        return scores
    cuda_lib.launch("sift3d_hough_scores", rots, scales, pts0, pts1, s0, s1, o0, o1, scores, m,
                    *thresholds, device=pts0.device)
    cuda_lib.count_launch(hough_scores)
    return scores


hough_scores.launches = 0


def hough_similarity(pts0, pts1, s0, s1, o0, o1, cfg: SiftConfig = DEFAULT_CONFIG, device=None):
    """Returns dict(hypothesis, rot [3,3] f64, scale, inliers [M] bool,
    score) for M >= 1 matches given as numpy arrays or tensors. device:
    None means the card (raises without one); "cpu" runs M3's plain
    version."""
    dev = resolve_device(device, like=pts0)

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

    # the hypotheses on the host (a few hundred small ops over M rows), the
    # same for every device
    rots, scales = (put(t) for t in hypotheses(*(torch.as_tensor(a, dtype=torch.float32, device="cpu") for a in (s0, s1, o0, o1))))
    pts0, pts1, s0, s1, o0, o1 = (put(a) for a in (pts0, pts1, s0, s1, o0, o1))
    thresholds = tuple(
        float(np.float32(t)) for t in (cfg.hough_thres_scale, cfg.hough_thres_trans, cfg.hough_thres_orien)
    )
    scores = hough_scores(rots, scales, pts0, pts1, s0, s1, o0, o1, thresholds)
    best = int(np.argmax(scores.cpu().numpy()))  # the first maximum
    rot, scale = rots[best], scales[best]
    inliers = hough_ok(rot[None], scale[None], pts0[best][None], pts1[best][None],
                       pts0, pts1, s0, s1, o0, o1, thresholds)[0]
    return dict(
        hypothesis=best,
        rot=rot.cpu().numpy().astype(np.float64),
        scale=float(scale),
        inliers=inliers.cpu().numpy(),
        score=float(scores[best]),
    )
