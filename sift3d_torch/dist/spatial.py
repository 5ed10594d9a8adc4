"""Z-sharded extraction for volumes too large for one card.

The port's counterpart of ``sift3d.dist.spatial`` (the CLI's --spatial).
The volume is zero-padded along Z to a shardable depth and split over a
mesh (``dist.mesh``); the first octaves run sharded end to end:

- every blur is K7 on a halo-extended shard, cropped (``dist.halo``), and
  planes past the true depth are re-zeroed after it (zero-border
  semantics: the single-device volume simply ends there);
- the DoGs are an elementwise difference on each shard;
- the extrema mask is K6 on each shard's DoGs with a one-plane halo, under
  the global z border rule (rows 0 and true_z - 1 and the padding are 0);
- each shard's candidate table is the port's ``candidate_table`` (exact
  counts: the JAX package's compaction, decoding and capacity buckets
  exist for XLA's static shapes and are not ported);
- each shard's feature stage runs on a Z slab of the Gaussian stack that
  covers every read its candidates' patches make, in global coordinates
  (K2 and K4 take the slab's origin and the true depth), so every row
  equals the single-device row;
- the rows are merged on the host into the global reference order.

Once the octave base has halved ``sharded_octaves`` times, it is gathered
on mesh[0] and the remaining octaves run the single-device pipeline with
``pre_blurred=True``. Under ``prescale`` the volume is prescaled on mesh[0]
by ``pipeline/extract.py`` (``prescaled_volume``) and its extraction grid is
sharded. Equal to ``extract_features`` on the whole volume
(tests/test_torch_spatial*.py).
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig, initial_blur_sigma
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.dist.halo import blur3d_sharded, exchange_halo_z, planes, shard_volume
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.kernels.extrema_cuda import extrema_mask
from sift3d_torch.kernels.resample import subsample_2x
from sift3d_torch.pipeline import extract, features, pyramid
from sift3d_torch.utils.timing import TRACER, Tracer

WORKING_SET_LIMIT = 2 * 1024**3  # bytes of an octave's 11 f32 volumes that shard it


def _zero_tail(shards: Sequence[torch.Tensor], true_z: int) -> List[torch.Tensor]:
    """Zero every plane with global z >= true_z (the Z padding)."""
    tz = shards[0].shape[-3]
    out = []
    for i, s in enumerate(shards):
        lo = true_z - i * tz
        if lo < tz:
            s = s.clone()
            s[..., max(lo, 0) :, :, :] = 0.0
        out.append(s)
    return out


def _extrema_sharded(dogs: Sequence[torch.Tensor], true_z: int) -> List[torch.Tensor]:
    """[3, tz, Y, X] int8 masks of Z-sharded [5, tz, Y, X] DoGs: K6 on each
    shard with a one-plane halo, cropped, then the global z border rule
    (``spatial._extrema_sharded``, spatial.py:73-102)."""
    tz = dogs[0].shape[1]
    out = []
    for i, ext in enumerate(exchange_halo_z(dogs, 1)):
        m = extrema_mask(ext)[:, 1:-1].contiguous()
        # the single-device scan is interior-only in the true volume
        if i == 0:
            m[:, 0] = 0
        m[:, max(true_z - 1 - i * tz, 0) :] = 0
        out.append(m)
    return out


class ShardedOctave(NamedTuple):
    gstack: List[torch.Tensor]  # per shard [6, tz, Y, X]
    dogs: List[torch.Tensor]  # per shard [5, tz, Y, X]
    mask: List[torch.Tensor]  # per shard [3, tz, Y, X] int8
    next_base: List[torch.Tensor]  # per shard [tz / 2, Y / 2, X / 2]


def initial_blur_spatial(
    shards: Sequence[torch.Tensor], cfg: SiftConfig, true_z: int, scale: float = 1.0,
) -> List[torch.Tensor]:
    """Raise a Z-sharded input of initial image scale `scale` to sigma_base
    (``pyramid.initial_blur_core``)."""
    sigma = initial_blur_sigma(cfg, scale)
    return _zero_tail(blur3d_sharded(shards, sigma, cfg.blur_precision), true_z)


def octave_step_spatial(base: Sequence[torch.Tensor], cfg: SiftConfig, true_z: int) -> ShardedOctave:
    """One octave of a Z-sharded base whose true depth is true_z
    (``pyramid.octave_core`` over shards)."""
    inc = cfg.incremental_sigmas()
    levels = [list(base)]
    for j in range(1, cfg.blurs_total):
        levels.append(_zero_tail(blur3d_sharded(levels[-1], inc[j - 1], cfg.blur_precision), true_z))
    next_base = _zero_tail([subsample_2x(s) for s in levels[cfg.blurs_per_octave]], true_z // 2)
    gstack = [torch.stack(shard_levels) for shard_levels in zip(*levels)]
    del levels
    dogs = [g[:-1] - g[1:] for g in gstack]
    return ShardedOctave(gstack, dogs, _extrema_sharded(dogs, true_z), next_base)


def sampling_halo(cfg: SiftConfig) -> int:
    """Planes beyond a shard that its candidates' patches can read
    (``spatial._sampling_halo``): rotated 11^3 points reach 2 sqrt(3) scale
    from the centre, the refined centre lies within 1.5 voxels of its
    candidate, and the 2-tap interpolation reads one plane further; scale <
    2 sigma[lvl + 1] <= 2 sigmas[-2] for a strict extremum."""
    max_scale = 2.0 * cfg.level_sigmas()[-2]
    return int(math.ceil(2.0 * math.sqrt(3.0) * max_scale + 3.0))


def emit_octave_spatial(
    octv: ShardedOctave, cfg: SiftConfig, true_z: int, timer: Tracer, descriptor: str = "goh",
) -> Optional[dict]:
    """Every feature row of a Z-sharded octave, as numpy arrays in global
    octave geometry, in reference push order (``spatial.
    _extract_octave_spatial``, spatial.py:319-439)."""
    tz = octv.mask[0].shape[1]
    sigmas = tuple(cfg.level_sigmas())
    halo = sampling_halo(cfg)
    with timer.stage("candidates"):
        tables = []
        for i, m in enumerate(octv.mask):
            lvl, zyx, sign = features.candidate_table(m)
            zyx[:, 0] += i * tz
            tables.append((lvl, zyx, sign))
        # reference order: per DoG level, valleys before peaks, then scan
        # order; shards hold ascending z runs and each table is in scan
        # order, so a stable sort of the shard-ordered tables on the group
        # alone gives every candidate its global rank
        group = torch.cat([(lvl * 2 + (sign > 0)).cpu() for lvl, _, sign in tables])
        rank = torch.empty_like(group)
        rank[torch.argsort(group, stable=True)] = torch.arange(group.shape[0])
        ranks = torch.split(rank, [t[0].shape[0] for t in tables])
    parts = []
    for i, (table, rank_i) in enumerate(zip(tables, ranks)):
        if table[0].shape[0] == 0:
            continue
        dev = octv.gstack[i].device
        # the Gaussian planes the shard's patches read, clipped to the true
        # volume (the samplers clamp in global coordinates)
        z0, z1 = max(i * tz - halo, 0), min((i + 1) * tz + halo, true_z)
        gslab = planes(octv.gstack, z0, z1, dev)
        dslab = planes(octv.dogs, i * tz - 1, (i + 1) * tz + 1, dev)
        rows = features.emit_candidates(
            gslab, dslab, table, cfg, sigmas, timer, descriptor,
            rank=rank_i.to(dev), gz0=z0, dz0=i * tz - 1, depth=true_z,
        )
        del gslab, dslab
        if rows is not None:
            parts.append({k: v.cpu().numpy() for k, v in rows.items()})
    if not parts:
        return None
    rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.argsort(rows["key"], kind="stable")
    return {k: v[order] for k, v in rows.items()}


def sharded_octave_count(shape, cfg: SiftConfig, sharded_octaves: Optional[int] = None) -> int:
    """Octaves to shard: the given count clamped to the pyramid, or (None)
    those whose 11-volume f32 working set (6 Gaussian + 5 DoG levels)
    exceeds 2 GiB (spatial.py:477-484)."""
    n_oct = pyramid.num_octaves(tuple(shape), cfg)
    if sharded_octaves is not None:
        return max(0, min(int(sharded_octaves), n_oct))
    k, v = 0, int(np.prod(shape))
    while k < n_oct and v * 11 * 4 > WORKING_SET_LIMIT:
        k += 1
        v //= 8
    return k


def extract_features_spatial(
    img, mesh: Optional[Sequence] = None, cfg: SiftConfig = DEFAULT_CONFIG, *,
    sharded_octaves: Optional[int] = None, prescale: Optional[str] = None,
    descriptor: str = "goh", timer: Optional[Tracer] = None,
    on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> FeatureSet:
    """Extract features from a [Z, Y, X] volume (numpy array or tensor)
    Z-sharded over `mesh` (``make_mesh``'s device list; None: every CUDA
    device, raising without one).

    The first `sharded_octaves` octaves of the extraction grid run sharded
    (None: those whose working set exceeds 2 GiB); the rest run on
    mesh[0]. With no sharded octave or a one-device mesh this is
    ``extract_features`` on mesh[0]. prescale (but "isotropic", which
    raises), descriptor, timer and on_gstack as there (on_gstack gets each
    sharded octave's stack gathered on mesh[0]). Returns what ``extract_features`` returns for the
    whole volume, in the input volume's voxels.
    """
    if prescale == "isotropic":
        raise ValueError("the Z-sharded path takes no prescale 'isotropic': resample the Scan first "
                         "(pipeline.extract.prescaled_volume) and map its features with in_world_mm")
    mesh = make_mesh() if mesh is None else [torch.device(d) for d in mesh]
    mesh = [resolve_device(d) for d in mesh]
    timer = timer or TRACER
    scale = extract._initial_scale(prescale)
    zd, yd, xd = extract.extraction_shape(extract._shape(img), prescale)
    n = len(mesh)
    n_oct = pyramid.num_octaves((zd, yd, xd), cfg)
    k_shard = sharded_octave_count((zd, yd, xd), cfg, sharded_octaves)
    if k_shard == 0 or n == 1:
        return extract.extract_features(
            img, cfg, mesh[0], timer, prescale=prescale, descriptor=descriptor, on_gstack=on_gstack,
        )

    vol = extract.prescaled_volume(img, prescale, mesh[0])
    # pad Z so every sharded octave shards and subsamples evenly
    mult = n * 2**k_shard
    zp = -(-zd // mult) * mult
    if zp > zd:
        vol = torch.cat([vol, vol.new_zeros((zp - zd, yd, xd))])
    base = shard_volume(vol, mesh)
    del vol
    with timer.stage("initial_blur"):
        base = initial_blur_spatial(base, cfg, zd, scale)
    true_z = zd
    parts = []
    for octave in range(k_shard):
        with timer.stage("pyramid"):
            octv = octave_step_spatial(base, cfg, true_z)
        if on_gstack is not None:
            on_gstack(octave, planes(octv.gstack, 0, true_z, mesh[0]))
        rows = emit_octave_spatial(octv, cfg, true_z, timer, descriptor)
        if rows is not None:
            parts.append(extract.octave_features(rows, octave))
        base = octv.next_base
        true_z //= 2
        del octv
    if k_shard < n_oct:
        tail = planes(base, 0, true_z, mesh[0])
        del base

        def tail_gstack(octave, gstack):
            on_gstack(k_shard + octave, gstack)

        for octave, rows in extract.extract_octaves(
            tail, cfg, mesh[0], timer, descriptor=descriptor, pre_blurred=True,
            on_gstack=None if on_gstack is None else tail_gstack,
        ):
            parts.append(extract.octave_features(rows, k_shard + octave))
    return extract._in_input_voxels(FeatureSet.concatenate(parts), prescale)
