"""Feature stage: candidates, refinement, eigen test, canonical
orientations, row emission and descriptors.

PyTorch port of ``sift3d.pipeline.features`` for one volume, run eagerly
on exact row counts (the JAX package's fixed-capacity chunks and buckets
exist for XLA's static shapes and are dropped). The reference call stack
(SURVEY.md section 3.2):

    generateFeatures3D_efficient       MultiScale.cpp:1326-1424
      interpolate_discrete_3D_point    :1614  (per-axis quadratic refinement)
      interpolate_extremum_quadratic   :1641  (scale interpolation, x2)
      generateFeature3D                :1705
        sampleImage3D                  :2614  (11^3 trilinear patch)
        NormalizeData                  :127
        determineOrientation3D         :2541  (structure tensor + 3x3 eigen)
        eig threshold reject           :1748-1769
        determineCanonicalOrientation3D:2722  (spherical histogram peaks)

The samplers (K2, K4) and the histogram top-k (K3) are CUDA kernels on a
CUDA device and their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.core.featureset import INFO_FLAG_MIN0MAX1, INFO_FLAG_REORIENT
from sift3d_torch.core.numerics import fma, sqrt
from sift3d_torch.kernels import descriptor as desc_kernels
from sift3d_torch.kernels.extrema import quadratic_interp_1d
from sift3d_torch.kernels.gauss import gaussian_kernel_1d
from sift3d_torch.kernels.hist_cuda import hist_band, hist_topk
from sift3d_torch.kernels.patch import (
    PATCH_DIM,
    PATCH_RAD,
    normalize_patches,
    patch_gradients,
    sphere_mask,
    structure_tensor_eigs,
)
from sift3d_torch.kernels.patch_cuda import sample_identity, sample_rotated


def candidate_table(mask: torch.Tensor):
    """Candidates of one octave's [3, Z, Y, X] int8 extrema mask in the
    reference's emission order: DoG level, then valleys before peaks, then
    scan order (generateFeatures3D_efficient loops, MultiScale.cpp:425-467).

    nonzero returns rows in flat (level, z, y, x) order, so a stable sort on
    level * 2 + (peak?) alone reproduces the JAX package's tables
    (extract.py:250-256). Returns (lvl [N] DoG level 1..3, zyx [N, 3],
    sign [N] +1 peak / -1 valley), all int64.
    """
    nz = torch.nonzero(mask)
    sign = mask[nz[:, 0], nz[:, 1], nz[:, 2], nz[:, 3]].to(torch.int64)
    order = torch.argsort(nz[:, 0] * 2 + (sign > 0), stable=True)
    nz, sign = nz[order], sign[order]
    return nz[:, 0] + 1, nz[:, 1:4], sign


def gather_stage(gstack, dogs, lvl, zyx, sigmas: Sequence[float]):
    """Refine candidates and sample their identity-orientation patches.

    gstack [6, Z, Y, X] / dogs [5, Z, Y, X] of one octave; lvl [C] DoG level
    1..3; zyx [C, 3] voxel coords. Returns (xyz [C, 3] (x, y, z, +0.5
    shifted), scale [C], in_bounds [C], patches [C, 11, 11, 11]) as
    ``features.gather_stage_union`` (features.py:315-410) for one volume.
    """
    zd, yd, xd = dogs.shape[1:]
    f32 = torch.float32
    z, y, x = zyx[:, 0], zyx[:, 1], zyx[:, 2]
    d_c = dogs[lvl, z, y, x]
    # spatial refinement: per-axis independent quadratic on the centre level
    fx = quadratic_interp_1d(
        dogs[lvl, z, y, x - 1], d_c, dogs[lvl, z, y, x + 1],
        (x - 1).to(f32), x.to(f32), (x + 1).to(f32),
    )
    fy = quadratic_interp_1d(
        dogs[lvl, z, y - 1, x], d_c, dogs[lvl, z, y + 1, x],
        (y - 1).to(f32), y.to(f32), (y + 1).to(f32),
    )
    fz = quadratic_interp_1d(
        dogs[lvl, z - 1, y, x], d_c, dogs[lvl, z + 1, y, x],
        (z - 1).to(f32), z.to(f32), (z + 1).to(f32),
    )
    # scale refinement across DoG levels at the integer voxel, x2
    # (generateFeatures3D_efficient, MultiScale.cpp:1376-1381)
    sig = torch.tensor(list(sigmas), dtype=f32, device=dogs.device)
    scale = 2.0 * quadratic_interp_1d(
        dogs[lvl - 1, z, y, x], d_c, dogs[lvl + 1, z, y, x], sig[lvl - 1], sig[lvl], sig[lvl + 1]
    )
    # subpixel centre shift (MultiScale.cpp:1384-1386)
    xyz = torch.stack([fx + 0.5, fy + 0.5, fz + 0.5], dim=-1)
    # bounds test (sampleImage3D, MultiScale.cpp:2630-2643)
    rad_max = torch.floor(2.0 * scale + 2.0)[:, None]
    hi = torch.tensor([xd, yd, zd], dtype=f32, device=dogs.device)
    in_bounds = ((xyz - rad_max >= 0.0) & (xyz + rad_max < hi)).all(dim=-1)
    patches = sample_identity(gstack, lvl.to(torch.int32), xyz, scale)
    return xyz, scale, in_bounds, patches


def eig_stage(patches, cfg: SiftConfig):
    """Normalize + structure-tensor eigendecomposition + edge rejection.
    Returns (patches_norm, eigs, eig_ori, eig_keep)."""
    pn = normalize_patches(patches)
    eigs, eig_ori = structure_tensor_eigs(pn)
    if cfg.eig_threshold < 0:
        eig_keep = torch.ones(pn.shape[0], dtype=torch.bool, device=pn.device)
    else:
        # keep iff (sum)^3 < thres * prod (MultiScale.cpp:1763)
        s = eigs[:, 0] + eigs[:, 1] + eigs[:, 2]
        p = eigs[:, 0] * eigs[:, 1] * eigs[:, 2]
        eig_keep = s * s * s < cfg.eig_threshold * p
    return pn, eigs, eig_ori, eig_keep


# The canonical stage's 3-vector algebra rounds as the compiled JAX package
# rounds it: XLA's CPU code fuses these multiplies into adds, and the
# orientations then agree to the bit.


def _fdot3(a, b):
    """a . b over 3 components (sequences of tensors): a chain of fused
    multiply-adds, x first."""
    return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]))


def _fcross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over a trailing axis of 3, each a_i b_j - a_j b_i with the
    first product fused."""
    return torch.stack(
        [fma(a[..., i], b[..., j], -(a[..., j] * b[..., i])) for i, j in ((1, 2), (2, 0), (0, 1))],
        dim=-1,
    )


def _norm_or_x(v: torch.Tensor) -> torch.Tensor:
    """Normalize rows; zero vectors become (1, 0, 0) (vec3D_norm_3d,
    MultiScale.cpp:1092-1111)."""
    ss = _fdot3(v.unbind(-1), v.unbind(-1))[..., None]
    unit = v / sqrt(torch.where(ss > 0, ss, torch.ones_like(ss)))
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    return torch.where(ss > 0, unit, fallback)


def hist_tops(hx, hy, hz, w, band, k: int):
    """Blurred-histogram top-k peaks and their subvoxel interpolations
    (K3 + the quadratic fit, ``features._hist_tops_fused``).

    Returns (vals [C, k], valid [C, k], itp [C, k, 3] continuous (x, y, z))."""
    out = hist_topk(hx.contiguous(), hy.contiguous(), hz.contiguous(), w.contiguous(), band, k)
    v = out[..., 0]
    valid = torch.isfinite(v)
    flat = out[..., 7].to(torch.int64)
    px = flat % 16
    pp = flat // 16
    pz, py = pp // PATCH_DIM, pp % PATCH_DIM

    def quad(vm, vp, coord):
        cf = coord.to(torch.float32)
        return quadratic_interp_1d(vm, v, vp, cf - 1.0, cf, cf + 1.0)

    itp = torch.stack(
        [quad(out[..., 1], out[..., 2], px), quad(out[..., 3], out[..., 4], py),
         quad(out[..., 5], out[..., 6], pz)],
        dim=-1,
    )
    return v, valid, itp


def sphere_edges(pn):
    """Unit gradient directions and magnitudes of normalized patches over
    the in-sphere voxels (the only ones the reference splats), in
    [C, 3, V] / [C, V] layout."""
    c = pn.shape[0]
    grads = patch_gradients(pn)
    sphere_idx = torch.from_numpy(np.nonzero(sphere_mask().ravel())[0]).to(pn.device)
    g3 = grads.reshape(c, 3, -1)[:, :, sphere_idx]
    mag = sqrt(_fdot3(g3.unbind(1), g3.unbind(1)))
    wgt = torch.where(mag > 0, mag, torch.zeros_like(mag))
    e3 = g3 / torch.where(mag > 0, mag, torch.ones_like(mag))[:, None, :]
    return e3, wgt


def splat_coords(e):
    """Histogram bin coordinates e * rad + rad of unit directions [R, 3, V];
    returns (hx, hy, hz), each [R, V]. The reference splats at
    e * rad + rad + 0.5 with 0.5-voxel centres (MultiScale.cpp:2805-2816);
    the compiled JAX package folds that + 0.5 and the interpolation's - 0.5
    away and rounds the product and the sum separately, as here."""
    rad = float(PATCH_RAD)
    return tuple(e[:, i] * rad + rad for i in range(3))


def ori_hist_band(cfg: SiftConfig, device) -> torch.Tensor:
    """The [11, 11] blur band of the orientation histograms."""
    taps = gaussian_kernel_1d(cfg.ori_hist_blur_sigma, 0.01)
    return torch.from_numpy(hist_band(taps)).to(device)


def canonical_stage(pn, cfg: SiftConfig, kvalid=None):
    """Canonical orientations from blurred 11^3 direction histograms
    (``features.canonical_stage``, features.py:526-657).

    pn: [C, 11, 11, 11] normalized patches; kvalid: optional [C] survivor
    mask (secondaries run only for live primaries of live rows). Returns
    dict with ori [C, K1, K2, 3, 3] (rows = P1/P2/P3) and ori_valid
    [C, K1, K2].
    """
    k1 = cfg.max_primary_orientations
    k2 = cfg.max_secondary_orientations
    c = pn.shape[0]
    dev = pn.device
    band = ori_hist_band(cfg, dev)
    e3, wgt = sphere_edges(pn)
    rad = float(PATCH_RAD)

    # primary histogram
    v1, pk1, itp1 = hist_tops(*splat_coords(e3), wgt, band, k1)
    # threshold: >= 0.8 * strongest (strict < breaks, MultiScale.cpp:2889)
    valid1 = pk1 & (v1 >= cfg.ori_peak_threshold * v1[:, :1]) & (v1 > 0)
    p1 = _norm_or_x(itp1 - rad)  # [C, K1, 3]

    # secondary histograms on the projection perpendicular to each live
    # primary, for (candidate, primary) slots that can emit
    flags2 = valid1 if kvalid is None else (valid1 & kvalid[:, None])
    sidx = torch.nonzero(flags2.reshape(-1))[:, 0]
    ci, ki = sidx // k1, sidx % k1
    e3_r = e3[ci]  # [R, 3, V]
    p1_r = p1[ci, ki]  # [R, 3]
    p1v = p1_r[..., None].expand_as(e3_r)
    par = _fdot3(e3_r.unbind(1), p1v.unbind(1))
    perp = fma(-par[:, None, :].expand_as(e3_r), p1v, e3_r)
    pss = _fdot3(perp.unbind(1), perp.unbind(1))[:, None, :]
    ex = torch.zeros_like(perp)
    ex[:, 0] = 1.0
    perp = torch.where(pss > 0, perp / sqrt(torch.where(pss > 0, pss, torch.ones_like(pss))), ex)
    v2, pk2, itp2 = hist_tops(*splat_coords(perp), wgt[ci], band, k2)
    valid2r = pk2 & (v2 >= cfg.ori_2nd_peak_threshold * v2[:, :1]) & (v2 > 0)
    # interp, orthogonalize against P1, renormalize (MultiScale.cpp:3006-3015),
    # third axis = cross
    p2 = _norm_or_x(itp2 - rad)  # [R, K2, 3]
    p1k = p1_r[:, None, :].expand_as(p2)
    par2 = _fdot3(p2.unbind(-1), p1k.unbind(-1))[..., None]
    p2 = _norm_or_x(fma(-par2.expand_as(p2), p1k, p2))
    orir = torch.stack([p1k, p2, _fcross3(p1k, p2)], dim=2)  # [R, K2, 3, 3]
    valid2 = torch.zeros((c * k1, k2), dtype=torch.bool, device=dev)
    valid2[sidx] = valid2r
    ori = torch.zeros((c * k1, k2, 3, 3), dtype=torch.float32, device=dev)
    ori[sidx] = orir
    return dict(ori=ori.reshape(c, k1, k2, 3, 3), ori_valid=valid2.reshape(c, k1, k2))


def reoriented_slots(ori_valid, cfg: SiftConfig):
    """(row, slot) of every reoriented copy, in reference push order: per
    candidate, valid (primary, secondary) slots in priority order, capped at
    cfg.max_orientations (features.py:834-837). Returns (row [M], slot [M])
    with slot in [0, K1*K2)."""
    c, k1, k2 = ori_valid.shape
    ovf = ori_valid.reshape(c, k1 * k2)
    rank = torch.cumsum(ovf.to(torch.int32), dim=1) - 1
    nz = torch.nonzero(ovf & (rank < cfg.max_orientations))
    return nz[:, 0], nz[:, 1]


def descriptor_stage(patches):
    """NormalizeData + GoH + rank normalization (featExtract.cpp:477-499);
    [C, 11, 11, 11] -> [C, 64] ranks 0..63 as uint8."""
    pn = normalize_patches(patches)
    d = desc_kernels.normalize_positive(desc_kernels.goh_descriptor(pn))
    return desc_kernels.rank_normalize(d).to(torch.uint8)


def emit_octave(gstack, dogs, mask, cfg: SiftConfig, sigmas: Sequence[float], timer):
    """Every feature row of one octave, in reference push order.

    For each surviving candidate: its unoriented row (ori = structure-tensor
    eigenvectors) with order key cand * (1 + S), then its reoriented copies
    with keys cand * (1 + S) + slot + 1, S = K1 * K2 (features.py:742-865).
    Returns None when the octave has no survivor, else a dict of tensors in
    octave-local geometry: xyz, scale, eigs, ori, info, desc (uint8), key.
    """
    with timer.stage("candidates"):
        lvl, zyx, sign = candidate_table(mask)
    if lvl.shape[0] == 0:
        return None
    with timer.stage("gather_eig"):
        xyz, scale, in_bounds, patches = gather_stage(gstack, dogs, lvl, zyx, sigmas)
        pn, eigs, eig_ori, eig_keep = eig_stage(patches, cfg)
        kidx = torch.nonzero(in_bounds & eig_keep)[:, 0]
    if kidx.shape[0] == 0:
        return None
    xyz, scale, eigs, eig_ori, pn = xyz[kidx], scale[kidx], eigs[kidx], eig_ori[kidx], pn[kidx]
    lvl, sign = lvl[kidx], sign[kidx]
    with timer.stage("canonical"):
        o = canonical_stage(pn, cfg)
        row, slot = reoriented_slots(o["ori_valid"], cfg)
    s = cfg.max_primary_orientations * cfg.max_secondary_orientations
    ori_r = o["ori"].reshape(-1, s, 3, 3)[row, slot]
    with timer.stage("rotated_patches"):
        patches_r = sample_rotated(gstack, lvl[row].to(torch.int32), xyz[row], scale[row], ori_r)
    with timer.stage("descriptors"):
        desc = torch.cat([descriptor_stage(pn), descriptor_stage(patches_r)])
    info_u = torch.where(sign > 0, INFO_FLAG_MIN0MAX1, 0).to(torch.int64)
    return dict(
        xyz=torch.cat([xyz, xyz[row]]),
        scale=torch.cat([scale, scale[row]]),
        eigs=torch.cat([eigs, eigs[row]]),
        ori=torch.cat([eig_ori, ori_r]),
        info=torch.cat([info_u, info_u[row] | INFO_FLAG_REORIENT]),
        desc=desc,
        key=torch.cat([kidx * (1 + s), kidx[row] * (1 + s) + slot + 1]),
    )
