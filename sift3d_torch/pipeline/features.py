"""Feature stage: candidates, refinement, eigen test, canonical
orientations, row emission and descriptors.

PyTorch port of ``sift3d.pipeline.features``, run eagerly on exact row
counts (the JAX package's fixed-capacity chunks and buckets exist for XLA's
static shapes and are dropped). An octave's stage runs once over the
candidate union of a batch of same-shape volumes: every row carries its
volume index vi, the fused K2 reads volume vi's stacks, the fused K4 samples
level vi * 6 + l of the flattened [B * 6, Z, Y, X] stack, and everything
between is row-wise (features.py:315-370). The reference call stack
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

On a CUDA device three kernels carry the stage, and their plain versions
run on the CPU: the fused K2 (:func:`gather_eig`: refinement, identity
patch, normalization, structure tensor, eigen test), the fused canonical
stage (:func:`canonical_stage`: both orientation histograms, their peaks
and the frames, ``hist_cuda.canonical_orientations``), and the fused K4
(``patch_cuda.rotated_goh`` and ``goh``: rotated patch and GoH
descriptor; ``rotated_brief`` and ``brief`` for the BRIEF family).

The stage also runs on a Z slab of an octave (the Z-sharded path,
``sift3d_torch.dist.spatial``): the Gaussian stack and the DoGs may each
start at a global plane (gz0, dz0) of an octave `depth` planes deep, the
candidates carry global z, and every coordinate stays global, so a slab
gives the rows the whole octave gives (the JAX package's z_bounds /
gz_shift / g_dims, features.py:314-400, 806-920, in global terms).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.core.featureset import INFO_FLAG_MIN0MAX1, INFO_FLAG_REORIENT
from sift3d_torch.core.numerics import fma_exact, sqrt
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.extrema import quadratic_interp_1d
from sift3d_torch.kernels.gauss import gaussian_kernel_1d
from sift3d_torch.kernels.hist_cuda import canonical_orientations, hist_band, hist_topk
from sift3d_torch.kernels.patch import (
    PATCH_DIM,
    PATCH_RAD,
    normalize_patches,
    patch_gradients,
    sphere_mask,
    structure_tensor_eigs,
)
from sift3d_torch.kernels.patch_cuda import (
    _slab_args,
    brief,
    goh,
    rotated_brief,
    rotated_goh,
    sample_identity_plain,
)
from sift3d_torch.utils.timing import TRACER


def candidate_union(mask: torch.Tensor):
    """The candidates of a batch's [B, 3, Z, Y, X] int8 extrema masks, one
    table: volume by volume, each in the reference's emission order (DoG
    level, then valleys before peaks, then scan order;
    generateFeatures3D_efficient loops, MultiScale.cpp:425-467), the JAX
    package's union order (volume, level, sign, z, y, x), extract.py:719-759.

    nonzero returns rows in flat (volume, level, z, y, x) order, so a stable
    sort on (volume, level, peak?) alone gives that order. Returns (vi [N]
    volume index, lvl [N] DoG level 1..3, zyx [N, 3], sign [N] +1 peak / -1
    valley, rank [N] each row's index in its own volume's table), all int64.
    One host sync (nonzero).
    """
    nz = torch.nonzero(mask)
    sign = mask[nz[:, 0], nz[:, 1], nz[:, 2], nz[:, 3], nz[:, 4]].to(torch.int64)
    order = torch.argsort((nz[:, 0] * mask.shape[1] + nz[:, 1]) * 2 + (sign > 0), stable=True)
    nz, sign = nz[order], sign[order]
    vi = nz[:, 0].contiguous()
    # vi ascends: a row's rank is its index less its volume's first index
    rank = torch.arange(vi.shape[0], device=vi.device) - torch.searchsorted(vi, vi)
    return vi, nz[:, 1] + 1, nz[:, 2:5], sign, rank


def candidate_table(mask: torch.Tensor):
    """Candidates of one octave's [3, Z, Y, X] int8 extrema mask in the
    reference's emission order: :func:`candidate_union` of a batch of one.
    Returns (lvl [N], zyx [N, 3], sign [N]), all int64."""
    _, lvl, zyx, sign, _ = candidate_union(mask[None])
    return lvl, zyx, sign


def gather_stage(gstack, dogs, lvl, zyx, sigmas: Sequence[float], *, vi=None, gz0: int = 0,
                 dz0: int = 0, depth=None):
    """Refine candidates and sample their identity-orientation patches (K2's
    plain sampler): the first half of :func:`gather_eig_plain`.

    gstack [6, Z, Y, X] / dogs [5, Z, Y, X] of one octave, or Z slabs of
    it starting at global planes gz0 / dz0 of an octave `depth` planes deep
    (None: the DoGs' own depth); lvl [C] DoG level 1..3; zyx [C, 3] global
    voxel coords; vi [C]: each row's volume in [B, 6, ...] / [B, 5, ...]
    stacks of a batch (None: one volume). Returns (xyz [C, 3] (x, y, z,
    +0.5 shifted), scale [C], in_bounds [C], patches [C, 11, 11, 11]) as
    ``features.gather_stage_union`` (features.py:315-410).
    """
    glvl = dlvl = lvl
    if vi is not None:  # volume vi's level l is level vi * L + l of the flattened stacks
        glvl, dlvl = vi * gstack.shape[1] + lvl, vi * dogs.shape[1] + lvl
        gstack, dogs = gstack.flatten(0, 1), dogs.flatten(0, 1)
    zd, yd, xd = dogs.shape[1:]
    depth = zd if depth is None else depth
    f32 = torch.float32
    z, y, x = zyx[:, 0], zyx[:, 1], zyx[:, 2]
    zl = z - dz0  # plane index in the DoG slab; the abscissae stay global
    d_c = dogs[dlvl, zl, y, x]
    # spatial refinement: per-axis independent quadratic on the centre level
    fx = quadratic_interp_1d(
        dogs[dlvl, zl, y, x - 1], d_c, dogs[dlvl, zl, y, x + 1],
        (x - 1).to(f32), x.to(f32), (x + 1).to(f32),
    )
    fy = quadratic_interp_1d(
        dogs[dlvl, zl, y - 1, x], d_c, dogs[dlvl, zl, y + 1, x],
        (y - 1).to(f32), y.to(f32), (y + 1).to(f32),
    )
    fz = quadratic_interp_1d(
        dogs[dlvl, zl - 1, y, x], d_c, dogs[dlvl, zl + 1, y, x],
        (z - 1).to(f32), z.to(f32), (z + 1).to(f32),
    )
    # scale refinement across DoG levels at the integer voxel, x2
    # (generateFeatures3D_efficient, MultiScale.cpp:1376-1381)
    sig = torch.tensor(list(sigmas), dtype=f32, device=dogs.device)
    scale = 2.0 * quadratic_interp_1d(
        dogs[dlvl - 1, zl, y, x], d_c, dogs[dlvl + 1, zl, y, x], sig[lvl - 1], sig[lvl], sig[lvl + 1]
    )
    # subpixel centre shift (MultiScale.cpp:1384-1386)
    xyz = torch.stack([fx + 0.5, fy + 0.5, fz + 0.5], dim=-1)
    # bounds test (sampleImage3D, MultiScale.cpp:2630-2643)
    rad_max = torch.floor(2.0 * scale + 2.0)[:, None]
    hi = torch.tensor([xd, yd, depth], dtype=f32, device=dogs.device)
    in_bounds = ((xyz - rad_max >= 0.0) & (xyz + rad_max < hi)).all(dim=-1)
    patches = sample_identity_plain(gstack, glvl, xyz, scale, gz0, depth)
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


def gather_eig_plain(gstack, dogs, lvl, zyx, sigmas: Sequence[float], cfg: SiftConfig, *,
                     vi=None, gz0: int = 0, dz0: int = 0, depth=None):
    """The plain version of the fused K2 (:func:`gather_eig`):
    :func:`gather_stage`, then :func:`eig_stage`. Returns (xyz, scale,
    in_bounds, pn, eigs, ori, eig_keep)."""
    xyz, scale, in_bounds, patches = gather_stage(
        gstack, dogs, lvl, zyx, sigmas, vi=vi, gz0=gz0, dz0=dz0, depth=depth
    )
    return (xyz, scale, in_bounds, *eig_stage(patches, cfg))


def gather_eig(gstack, dogs, lvl, zyx, sigmas: Sequence[float], cfg: SiftConfig, *,
               vi=None, gz0: int = 0, dz0: int = 0, depth=None):
    """Fused K2: per candidate, the refinement, the 11^3 identity patch,
    its normalization, structure tensor, eigendecomposition and keep rule,
    in one launch with one block per row (``csrc/identity_eig.cu``); the
    raw patch never leaves the block. Arguments and results as
    :func:`gather_eig_plain`, which runs for CPU tensors: one volume's
    [6, Z, Y, X] / [5, Z, Y, X] stacks, or with vi [R] a batch's
    [B, 6, ...] / [B, 5, ...]."""
    if cuda_lib.route(gstack) == "plain":
        return gather_eig_plain(gstack, dogs, lvl, zyx, sigmas, cfg, vi=vi, gz0=gz0, dz0=dz0,
                                depth=depth)
    lvl, zyx = lvl.contiguous(), zyx.contiguous()  # zyx: a column slice of the candidate table
    ndim = 4 if vi is None else 5
    cuda_lib.require_cuda(gstack, "gstack", torch.float32, ndim)
    cuda_lib.require_cuda(dogs, "dogs", torch.float32, ndim)
    cuda_lib.require_cuda(lvl, "lvl", torch.int64, 1)
    cuda_lib.require_cuda(zyx, "zyx", torch.int64, 2)
    r = lvl.shape[0]
    if vi is not None:
        vi = vi.contiguous()
        cuda_lib.require_cuda(vi, "vi", torch.int64, 1)
        if vi.shape != (r,) or dogs.shape[0] != gstack.shape[0]:
            raise ValueError(f"vi [{vi.shape[0]}] against {r} rows, gstack {tuple(gstack.shape)} "
                             f"against dogs {tuple(dogs.shape)}")
    b = 1 if vi is None else gstack.shape[0]
    nl, zg, yd, xd = gstack.shape[-4:]
    nd, zd = dogs.shape[-4:-2]
    if dogs.shape[-2:] != (yd, xd) or zyx.shape != (r, 3) or nd > min(len(sigmas), 8):
        raise ValueError(f"gstack {tuple(gstack.shape)}, dogs {tuple(dogs.shape)}, lvl [{r}], zyx "
                         f"{tuple(zyx.shape)} and {len(sigmas)} sigmas do not fit together")
    gz0, depth = _slab_args(gstack.reshape(-1, zg, yd, xd), gz0, zd if depth is None else depth)
    dev = gstack.device
    if not dogs.device == lvl.device == zyx.device == dev or (vi is not None and vi.device != dev):
        raise ValueError(f"dogs, lvl, zyx and vi must be on {dev}")
    sig = torch.tensor(list(sigmas)[:nd], dtype=torch.float32)  # host memory: passed by value
    f32 = dict(dtype=torch.float32, device=dev)
    xyz, scale = torch.empty((r, 3), **f32), torch.empty((r,), **f32)
    pn = torch.empty((r, PATCH_DIM, PATCH_DIM, PATCH_DIM), **f32)
    eigs, ori = torch.empty((r, 3), **f32), torch.empty((r, 3, 3), **f32)
    in_bounds, keep = (torch.empty((r,), dtype=torch.bool, device=dev) for _ in range(2))
    if r:
        cuda_lib.launch(
            "sift3d_identity_eig", gstack, dogs, lvl, zyx, vi, sig, xyz, scale, pn, eigs, ori,
            in_bounds, keep, float(cfg.eig_threshold), r, b, nl, zg, nd, zd, yd, xd, gz0, int(dz0),
            depth, device=dev,
        )
    return xyz, scale, in_bounds, pn, eigs, ori, keep


# The canonical stage's 3-vector algebra rounds as the compiled JAX package
# rounds it: XLA's CPU code fuses these multiplies into adds, and the
# orientations then agree to the bit.


def _fdot3(a, b):
    """a . b over 3 components (sequences of tensors): a chain of fused
    multiply-adds, x first."""
    return fma_exact(a[2], b[2], fma_exact(a[1], b[1], a[0] * b[0]))


def _fcross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over a trailing axis of 3, each a_i b_j - a_j b_i with the
    first product fused."""
    i, j = [1, 2, 0], [2, 0, 1]
    return fma_exact(a[..., i], b[..., j], -(a[..., j] * b[..., i]))


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
    # the three axes' vertices in one call: lanes 1, 3, 5 hold the values
    # at x-1, y-1, z-1 and lanes 2, 4, 6 those at x+1, y+1, z+1
    cf = torch.stack([px, py, pz], dim=-1).to(torch.float32)
    itp = quadratic_interp_1d(out[..., 1:7:2], v[..., None], out[..., 2:7:2], cf - 1.0, cf, cf + 1.0)
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


@functools.lru_cache(maxsize=None)
def _host_ori_band(sigma: float) -> torch.Tensor:
    """The band in host memory, made once a sigma and only read: the fused
    kernels take it by value."""
    return torch.from_numpy(hist_band(gaussian_kernel_1d(sigma, 0.01)))


def canonical_stage(pn, cfg: SiftConfig, kvalid=None):
    """Canonical orientations: :func:`canonical_stage_plain` for CPU
    tensors, the fused pair of launches (``hist_cuda.canonical_orientations``,
    bit for bit the same) for CUDA tensors, with no host sync. Arguments and
    results as :func:`canonical_stage_plain`. Counts the rows in
    ``canonical_rows`` while ``TRACER`` records."""
    TRACER.count("canonical_rows", pn.shape[0])
    if cuda_lib.route(pn) == "plain":
        return canonical_stage_plain(pn, cfg, kvalid)
    ori, ori_valid = canonical_orientations(
        pn.contiguous(), _host_ori_band(cfg.ori_hist_blur_sigma), cfg.max_primary_orientations,
        cfg.max_secondary_orientations, cfg.ori_peak_threshold, cfg.ori_2nd_peak_threshold, kvalid,
    )
    return dict(ori=ori, ori_valid=ori_valid)


def canonical_stage_plain(pn, cfg: SiftConfig, kvalid=None):
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
    perp = fma_exact(-par[:, None, :].expand_as(e3_r), p1v, e3_r)
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
    p2 = _norm_or_x(fma_exact(-par2.expand_as(p2), p1k, p2))
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


def descriptor_stage(patches, variant: str = "goh", method: int = 2, blur_sigma: float = 0.95, out=None):
    """NormalizeData + descriptor + rank normalization (featExtract.cpp:477-499);
    [C, 11, 11, 11] -> [C, 64] ranks 0..63 as uint8, into `out` when
    given. variant: "goh" (the default), or "brief", "rrief", "nrrief" with
    pair table `method` and pre-blur `blur_sigma`; the fused K4 (goh,
    brief) on a CUDA tensor."""
    if variant == "goh":
        return goh(patches.contiguous(), out)
    return brief(patches.contiguous(), variant, method, blur_sigma, out)


def emit_octave(
    gstack, dogs, mask, cfg: SiftConfig, sigmas: Sequence[float], timer, descriptor: str = "goh",
):
    """Every feature row of one octave of a batch of same-shape volumes
    (gstack [B, 6, Z, Y, X], dogs [B, 5, ...], mask [B, 3, ...]), with
    `descriptor` ("goh", "brief", "rrief" or "nrrief") descriptors: the
    candidate union of `mask`, then :func:`emit_candidates` over it once.
    The rows carry their volume index vi and keys ranked within each
    volume."""
    with timer.stage("candidates"):
        vi, *cands, rank = candidate_union(mask)
    return emit_candidates(gstack, dogs, cands, cfg, sigmas, timer, descriptor, vi=vi, rank=rank)


def emit_candidates(
    gstack, dogs, cands, cfg: SiftConfig, sigmas: Sequence[float], timer, descriptor: str = "goh",
    *, vi=None, rank=None, gz0: int = 0, dz0: int = 0, depth=None,
):
    """Every feature row of a candidate table (lvl, zyx, sign) of one
    octave. gstack, dogs, vi, gz0, dz0, depth as in :func:`gather_stage`;
    rank [N]: each candidate's place in its volume's reference order (None:
    its index in the table).

    For each surviving candidate: its unoriented row (ori = structure-tensor
    eigenvectors) with order key rank * (1 + S), then its reoriented copies
    with keys rank * (1 + S) + slot + 1, S = K1 * K2 (features.py:742-865).
    Returns None when no candidate survives, else a dict of tensors in
    octave geometry: xyz, scale, eigs, ori, info, desc (uint8), key, and
    with vi the rows' volume indices, vi.
    """
    lvl, zyx, sign = cands
    if lvl.shape[0] == 0:
        return None
    with timer.stage("gather_eig"):
        xyz, scale, in_bounds, pn, eigs, eig_ori, eig_keep = gather_eig(
            gstack, dogs, lvl, zyx, sigmas, cfg, vi=vi, gz0=gz0, dz0=dz0, depth=depth
        )
        kidx = torch.nonzero(in_bounds & eig_keep)[:, 0]
    if kidx.shape[0] == 0:
        return None
    xyz, scale, eigs, eig_ori, pn = xyz[kidx], scale[kidx], eigs[kidx], eig_ori[kidx], pn[kidx]
    lvl, sign = lvl[kidx], sign[kidx]
    with timer.stage("canonical"):
        o = canonical_stage(pn, cfg)
        row, slot = reoriented_slots(o["ori_valid"], cfg)
    TRACER.count("reoriented_rows", row.shape[0])
    s = cfg.max_primary_orientations * cfg.max_secondary_orientations
    ori_r = o["ori"].reshape(-1, s, 3, 3)[row, slot]
    glvl = lvl
    if vi is not None:  # K4 samples level vi * 6 + l of the flattened [B * 6, Z, Y, X] stack
        vi = vi[kidx]
        glvl = vi * gstack.shape[1] + lvl
        gstack = gstack.flatten(0, 1)
    rows_r = (gstack, glvl[row].to(torch.int32), xyz[row], scale[row], ori_r.contiguous(), gz0, depth)
    n_u = kidx.shape[0]
    desc = torch.empty((n_u + row.shape[0], 64), dtype=torch.uint8, device=pn.device)
    with timer.stage("descriptors"):
        # the unoriented rows, then the reoriented: the fused K4 samples the
        # rotated patches and describes them in one launch
        descriptor_stage(pn, descriptor, cfg.brief_method, cfg.brief_blur_sigma, out=desc[:n_u])
        if descriptor == "goh":
            rotated_goh(*rows_r, out=desc[n_u:])
        else:
            rotated_brief(*rows_r, descriptor, cfg.brief_method, cfg.brief_blur_sigma, out=desc[n_u:])
    info_u = torch.where(sign > 0, INFO_FLAG_MIN0MAX1, 0).to(torch.int64)
    order = kidx if rank is None else rank[kidx]
    rows = dict(
        xyz=torch.cat([xyz, xyz[row]]),
        scale=torch.cat([scale, scale[row]]),
        eigs=torch.cat([eigs, eigs[row]]),
        ori=torch.cat([eig_ori, ori_r]),
        info=torch.cat([info_u, info_u[row] | INFO_FLAG_REORIENT]),
        desc=desc,
        key=torch.cat([order * (1 + s), order[row] * (1 + s) + slot + 1]),
    )
    if vi is not None:
        rows["vi"] = torch.cat([vi, vi[row]])
    return rows
