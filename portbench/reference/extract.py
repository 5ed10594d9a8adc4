"""Reference extraction: 3D SIFT features of one volume, on the CPU.

Written from the algorithm of the repository's JAX package (``sift3d/``,
which follows the Toews featExtract binary), as plain NumPy with PyTorch's
CPU elementwise ops and max pool for the volume-sized steps. It imports nothing of
either package and runs on the host, so neither the card nor the port's
code is on both sides of the comparison.

The steps, per volume (default configuration, GoH descriptors):

- Gaussian pyramid: the initial blur to sigma 1.6, per octave six levels
  (incremental blurs, separable FIR passes with zero borders), five
  DoG levels, the next octave from the 2x2x2 mean of level 3;
- candidates: strict extrema over the 80 neighbours in three DoG levels,
  interior voxels only;
- refinement: a parabola per axis through the centre and its two
  neighbours, the scale from a parabola through the three levels' sigmas
  (times 2), the +0.5 voxel-centre shift, the box test on 2·scale + 2
  (the parabola's determinants rounded as the JAX package's compiled
  program rounds them: see ``parabola_vertex``);
- the 11^3 identity patch (trilinear, 0.5-centre voxels) from the
  Gaussian level of the centre DoG, normalised; the structure tensor over
  the inscribed sphere, its eigenvalues (f64 ``eigh``) and the edge test
  (sum^3 < 140 · product);
- canonical orientations: the gradient directions splatted trilinearly
  into an 11^3 histogram weighted by magnitude, blurred (sigma 0.5), its
  strict peaks at >= 0.8 of the largest (up to 6), for each a second
  histogram of the directions projected off it, peaks at >= 0.5 (up to
  11), at most 11 reoriented copies a feature;
- descriptors: GoH (8 cube-corner orientation bins x 2x2x2 spatial bins),
  shifted positive, unit norm, replaced by ranks; an unoriented feature
  takes the identity patch, a reoriented one a patch sampled under its
  rotation.

``control=True`` computes the blur's products with both factors rounded to
TF32 (10 mantissa bits, round to nearest even), as a tensor core does with
TF32 on, summed in f32: the precision step below the configuration's f32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

PATCH_DIM = 11
PATCH_RAD = PATCH_DIM // 2
INFO_PEAK = 0x10
INFO_REORIENT = 0x20
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")

DEFAULTS = dict(
    blurs_per_octave=3, blurs_extra=3, blur_precision=0.01, sigma_base=1.6, sigma_init=0.5,
    eig_threshold=140.0, ori_hist_blur_sigma=0.5, ori_peak_threshold=0.8, ori_2nd_peak_threshold=0.5,
    max_orientations=11, max_primary_orientations=6, max_secondary_orientations=11,
)

# 8 GoH orientation bins: the cube's corner directions
_ORI_DIRS = np.array([[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)], np.float32)

f32 = np.float32


# ---------------------------------------------------------------------------
# Gaussian pyramid
# ---------------------------------------------------------------------------


def filter_size(sigma: float, min_value: float) -> int:
    """Odd FIR length whose truncated tail holds at most min_value of the
    discretely estimated mass (GaussianMask.cpp's rule)."""
    if sigma == 0:
        return 1
    total, i = 1.0, 0
    while True:
        i += 1
        prev = total
        total = prev + 2.0 * math.exp((i * i) / (-2.0 * sigma * sigma))
        if not total - prev > 1e-5:
            break
    value, i = 1.0, 1
    while value <= prev * (1.0 - min_value):
        value += 2.0 * math.exp((i * i) / (-2.0 * sigma * sigma))
        i += 1
    return 2 * (i - 1) + 1


def gaussian_taps(sigma: float, min_value: float) -> np.ndarray:
    """L1-normalised f32 Gaussian taps."""
    size = filter_size(sigma, min_value)
    if sigma <= 0.0:
        return np.ones(1, f32)
    j = np.arange(size, dtype=f32) - f32(size // 2)
    taps = f32(1.0 / (sigma * math.sqrt(2.0 * math.pi))) * np.exp((j * j) / f32(sigma * sigma) / f32(-2.0))
    taps = taps.astype(f32)
    return (taps / taps.sum(dtype=f32)).astype(f32)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def blur3d(vol: torch.Tensor, sigma: float, min_value: float, control: bool) -> torch.Tensor:
    """Separable zero-border Gaussian blur of a [Z, Y, X] f32 tensor: x,
    then y, then z, each output the sum of its taps' products in tap order
    (elementwise ops only, so every run and thread count gives the same
    bits)."""
    if sigma <= 0.0:
        return vol
    taps = gaussian_taps(sigma, min_value)
    rnd = tf32 if control else (lambda t: t)
    taps = rnd(torch.from_numpy(taps)).tolist()
    r = len(taps) // 2
    for axis in (2, 1, 0):
        src, n = rnd(vol), vol.shape[axis]
        out, prod = torch.zeros_like(vol), torch.empty_like(vol)
        for k, t in enumerate(taps):
            lo, hi = max(0, r - k), min(n, n + r - k)  # outputs o whose input o + k - r lies inside
            if hi <= lo:
                continue
            p = prod.narrow(axis, lo, hi - lo)
            torch.mul(src.narrow(axis, lo + k - r, hi - lo), t, out=p)
            out.narrow(axis, lo, hi - lo).add_(p)
        vol = out
    return vol


def subsample(vol: torch.Tensor) -> torch.Tensor:
    """Each output voxel the mean of its 2x2x2 block (odd tails dropped),
    the eight added in a fixed order."""
    z, y, x = (d // 2 for d in vol.shape)
    v = vol[: 2 * z, : 2 * y, : 2 * x]
    acc = v[0::2, 0::2, 0::2].clone()
    for dz, dy, dx in ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)):
        acc += v[dz::2, dy::2, dx::2]
    return acc / 8.0


def level_sigmas(p: dict) -> List[float]:
    factor = float(2.0 ** (1.0 / p["blurs_per_octave"]))
    return [p["sigma_base"] * factor**j for j in range(p["blurs_per_octave"] + p["blurs_extra"])]


def octaves(shape) -> int:
    n, (z, y, x) = 0, shape
    while z > 2 and y > 2 and x > 2:
        n += 1
        z, y, x = z // 2, y // 2, x // 2
    return n


def strict_extrema(dogs: torch.Tensor):
    """(dog level, z, y, x, sign) of the strict maxima (+1) and minima
    (-1) of levels 1..L-2 over their 80 neighbours, interior voxels."""
    out = []
    for sign in (1, -1):
        d = dogs * sign
        pooled = torch.nn.functional.max_pool3d(d[:, None], 3, stride=1, padding=1)[:, 0]
        for lvl in range(1, d.shape[0] - 1):
            c = d[lvl]
            cand = (c >= pooled[lvl]) & (c > pooled[lvl - 1]) & (c > pooled[lvl + 1])
            cand[0], cand[-1] = False, False
            cand[:, 0], cand[:, -1] = False, False
            cand[:, :, 0], cand[:, :, -1] = False, False
            zs, ys, xs = (t.numpy() for t in torch.nonzero(cand, as_tuple=True))
            if not len(zs):
                continue
            # >= the pooled maximum admits ties with a neighbour: keep only
            # centres strictly above all 26 of their own level
            dn = d[lvl].numpy()
            cv = dn[zs, ys, xs]
            strict = np.ones(len(zs), bool)
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dz or dy or dx:
                            strict &= cv > dn[zs + dz, ys + dy, xs + dx]
            n = int(strict.sum())
            out.append(np.stack([np.full(n, lvl), zs[strict], ys[strict], xs[strict], np.full(n, sign)], 1))
    return np.concatenate(out) if out else np.zeros((0, 5), np.int64)


# ---------------------------------------------------------------------------
# Patches and their geometry
# ---------------------------------------------------------------------------


def interp_coord(c: np.ndarray, dim: int):
    """Index i and weight w (v = w·v[i] + (1-w)·v[i+1]) for linear
    interpolation with voxel centres at i + 0.5, saturating at the ends."""
    ch = c - f32(0.5)
    i = np.clip(np.floor(ch).astype(np.int64), 0, dim - 2)
    w = (f32(1.0) - (ch - i.astype(f32))).astype(f32)
    w = np.where(c < 0.5, f32(1.0), w)
    w = np.where(c >= dim - 0.5, f32(0.0), w)
    return i, w.astype(f32)


_R = np.arange(-PATCH_RAD, PATCH_RAD + 1, dtype=f32)
_GZ, _GY, _GX = np.meshgrid(_R, _R, _R, indexing="ij")
GRID = np.stack([_GX.ravel(), _GY.ravel(), _GZ.ravel()], -1)  # [1331, (x, y, z)], z-major
SPHERE = ((_GZ * _GZ + _GY * _GY + _GX * _GX) < PATCH_RAD * PATCH_RAD).ravel()


CHUNK = 1024  # rows a step, to bound the [rows, 1331, ...] temporaries


def sample_patches(level: np.ndarray, centers: np.ndarray, scales: np.ndarray, rot=None) -> np.ndarray:
    """[C, 11, 11, 11] trilinear samples of a [Z, Y, X] level at
    centre + rot^-1 · grid · (2 scale / 5); x outside the volume reads 0."""
    if len(centers) > CHUNK:
        return np.concatenate([sample_patches(level, centers[i : i + CHUNK], scales[i : i + CHUNK],
                                              None if rot is None else rot[i : i + CHUNK])
                               for i in range(0, len(centers), CHUNK)])
    zd, yd, xd = level.shape
    pts = np.broadcast_to(GRID, (len(centers),) + GRID.shape)
    if rot is not None:
        inv = np.linalg.inv(rot.astype(np.float64)).astype(f32)
        pts = np.einsum("cij,vj->cvi", inv, GRID).astype(f32)
    fac = (f32(2.0) * scales / f32(PATCH_RAD)).astype(f32)
    coords = (pts * fac[:, None, None] + centers[:, None, :]).astype(f32)
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    ix, wx = interp_coord(x, xd)
    iy, wy = interp_coord(y, yd)
    iz, wz = interp_coord(z, zd)
    flat = level.reshape(-1)

    def at(dz, dy, dx):
        return flat[((iz + dz) * yd + (iy + dy)) * xd + (ix + dx)]

    one = f32(1.0)
    n00 = wx * at(0, 0, 0) + (one - wx) * at(0, 0, 1)
    n01 = wx * at(1, 0, 0) + (one - wx) * at(1, 0, 1)
    n10 = wx * at(0, 1, 0) + (one - wx) * at(0, 1, 1)
    n11 = wx * at(1, 1, 0) + (one - wx) * at(1, 1, 1)
    vals = wz * (wy * n00 + (one - wy) * n10) + (one - wz) * (wy * n01 + (one - wy) * n11)
    vals = np.where((x < 0) | (x >= xd), f32(0.0), vals)
    return vals.astype(f32).reshape(-1, PATCH_DIM, PATCH_DIM, PATCH_DIM)


def row_sums(a: np.ndarray) -> np.ndarray:
    """Each row's sum, added left to right (the same bits in every process,
    which numpy's vectorised reductions do not promise)."""
    return np.cumsum(a, axis=1, dtype=a.dtype)[:, -1:]


def normalize(patches: np.ndarray) -> np.ndarray:
    """Mean subtracted, unit L2 norm, a patch at a time."""
    flat = patches.reshape(len(patches), PATCH_DIM**3)
    c = flat - row_sums(flat) / f32(PATCH_DIM**3)
    n = np.sqrt(row_sums(c * c))
    return (c / np.where(n > 0, n, f32(1.0))).astype(f32).reshape(patches.shape)


def gradients(p: np.ndarray) -> np.ndarray:
    """[C, 3 (dx, dy, dz), 11, 11, 11] central differences, zero on every
    face of the patch."""
    g = np.zeros((len(p), 3) + p.shape[1:], f32)
    g[:, 0, 1:-1, 1:-1, 1:-1] = p[:, 1:-1, 1:-1, 2:] - p[:, 1:-1, 1:-1, :-2]
    g[:, 1, 1:-1, 1:-1, 1:-1] = p[:, 1:-1, 2:, 1:-1] - p[:, 1:-1, :-2, 1:-1]
    g[:, 2, 1:-1, 1:-1, 1:-1] = p[:, 2:, 1:-1, 1:-1] - p[:, :-2, 1:-1, 1:-1]
    return g


def fma(a, b, c):
    """a·b + c rounded once to f32 (the f64 product of two f32 is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)


def parabola_vertex(f_lo, f_c, f_hi, x_lo, x_c, x_hi):
    """Abscissa of the vertex of the parabola through three points, by
    Cramer's rule; x_c where the fit degenerates.

    The determinants' terms (~x^3 for x up to 180) cancel, so in f32 the
    vertex moves by about 1e-2 voxels with where the sum rounds. They are
    evaluated as the JAX package's compiled CPU program evaluates them, a
    chain of fused multiply-adds (equal to it on 200,000 random triples;
    ``tests/test_portbench_reference.py``)."""
    a1, a2, a3 = x_lo * x_lo, x_c * x_c, x_hi * x_hi

    def det3(p1, p2, p3, q1, q2, q3):  # det [[p1 p2 p3], [q1 q2 q3], [1 1 1]]
        t = fma(p1, q2, -(p1 * q3))
        t = fma(-p2, q1, t)
        t = fma(p3, q1, t)
        t = fma(p2, q3, t)
        return fma(-p3, q2, t)

    det = det3(a1, a2, a3, x_lo, x_c, x_hi)
    detx = det3(f_lo, f_c, f_hi, x_lo, x_c, x_hi)
    dety = det3(a1, a2, a3, f_lo, f_c, f_hi)
    ok = (det != 0) & (detx != 0)
    return np.where(ok, dety / np.where(ok, f32(-2.0) * detx, f32(1.0)), x_c).astype(f32)


def unit_or_x(v: np.ndarray) -> np.ndarray:
    """Rows scaled to unit length; zero rows become (1, 0, 0)."""
    ss = (v * v).sum(-1, keepdims=True, dtype=f32)
    u = v / np.sqrt(np.where(ss > 0, ss, f32(1.0)))
    x = np.zeros_like(v)
    x[..., 0] = 1.0
    return np.where(ss > 0, u, x).astype(f32)


def eigen(pn: np.ndarray):
    """Structure tensor of each normalised patch over the inscribed
    sphere: eigenvalues descending [C, 3] and eigenvectors as columns
    [C, 3, 3] (right-handed), from f64 ``eigh``."""
    g = gradients(pn).reshape(len(pn), 3, PATCH_DIM**3)[:, :, SPHERE].astype(np.float64)
    t = np.einsum("civ,cjv->cij", g, g)
    w, v = np.linalg.eigh(t)
    w, v = w[:, ::-1], v[:, :, ::-1]
    flip = np.linalg.det(v) < 0
    v[flip, :, 2] *= -1
    return w.astype(f32), v.astype(f32)


def blurred_histograms(cx, cy, cz, weights, taps) -> np.ndarray:
    """[R, 11, 11, 11] (z, y, x) histograms: each point splatted
    trilinearly (0.5-centre bins, saturating) with its weight, then a
    zero-border Gaussian blur along each axis."""
    if len(cx) > CHUNK:
        return np.concatenate([blurred_histograms(cx[i : i + CHUNK], cy[i : i + CHUNK], cz[i : i + CHUNK],
                                                  weights[i : i + CHUNK], taps) for i in range(0, len(cx), CHUNK)])
    r, v = cx.shape
    ix, wx = interp_coord(cx, PATCH_DIM)
    iy, wy = interp_coord(cy, PATCH_DIM)
    iz, wz = interp_coord(cz, PATCH_DIM)
    row = np.arange(r)[:, None] * PATCH_DIM**3
    idx, val = [], []
    for dz, fz in ((0, wz), (1, f32(1.0) - wz)):
        for dy, fy in ((0, wy), (1, f32(1.0) - wy)):
            for dx, fx in ((0, wx), (1, f32(1.0) - wx)):
                idx.append(row + ((iz + dz) * PATCH_DIM + (iy + dy)) * PATCH_DIM + (ix + dx))
                val.append((fz * fy * fx * weights).astype(np.float64))
    hist = np.bincount(np.concatenate(idx, 1).ravel(), np.concatenate(val, 1).ravel(), minlength=r * PATCH_DIM**3)
    hist = hist.astype(f32).reshape(r, PATCH_DIM, PATCH_DIM, PATCH_DIM)
    rad = len(taps) // 2
    for axis in (3, 2, 1):  # x, y, z: each output the sum of its taps' products in tap order
        out = np.zeros_like(hist)
        for k, t in enumerate(taps):
            lo, hi = max(0, rad - k), min(PATCH_DIM, PATCH_DIM + rad - k)
            dst = [slice(None)] * 4
            src = [slice(None)] * 4
            dst[axis], src[axis] = slice(lo, hi), slice(lo + k - rad, hi + k - rad)
            out[tuple(dst)] += t * hist[tuple(src)]
        hist = out
    return hist


def hist_peaks(hist: np.ndarray, k: int):
    """The k largest strict 26-neighbour interior peaks of each histogram
    (ties by flat index) and their parabola-refined (x, y, z) positions:
    (values [R, k], valid [R, k], position [R, k, 3])."""
    r = len(hist)
    pad = np.pad(hist, ((0, 0), (1, 1), (1, 1), (1, 1)))
    peak = np.ones(hist.shape, bool)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz or dy or dx:
                    peak &= hist > pad[:, 1 + dz : 12 + dz, 1 + dy : 12 + dy, 1 + dx : 12 + dx]
    peak[:, [0, -1]] = False
    peak[:, :, [0, -1]] = False
    peak[:, :, :, [0, -1]] = False
    flat = np.where(peak, hist, -np.inf).reshape(r, -1)
    order = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(flat, order, 1).astype(f32)
    valid = np.isfinite(vals)
    pz = np.clip(order // PATCH_DIM**2, 1, PATCH_DIM - 2)
    py = np.clip(order // PATCH_DIM % PATCH_DIM, 1, PATCH_DIM - 2)
    px = np.clip(order % PATCH_DIM, 1, PATCH_DIM - 2)
    rows = np.arange(r)[:, None]

    def along(dz, dy, dx, coord):
        c = coord.astype(f32)
        return parabola_vertex(hist[rows, pz - dz, py - dy, px - dx], hist[rows, pz, py, px],
                               hist[rows, pz + dz, py + dy, px + dx], c - f32(1.0), c, c + f32(1.0))

    pos = np.stack([along(0, 0, 1, px), along(0, 1, 0, py), along(1, 0, 0, pz)], -1)
    return vals, valid, pos


def canonical(pn: np.ndarray, p: dict):
    """Canonical orientations of normalised identity patches: ori
    [C, K1, K2, 3, 3] (rows P1, P2, P3) and valid [C, K1, K2]."""
    k1, k2 = p["max_primary_orientations"], p["max_secondary_orientations"]
    c = len(pn)
    g = gradients(pn).reshape(c, 3, PATCH_DIM**3)[:, :, SPHERE]
    mag = np.sqrt((g * g).sum(1, dtype=f32))
    wgt = np.where(mag > 0, mag, f32(0.0)).astype(f32)
    e = (g / np.where(mag > 0, mag, f32(1.0))[:, None, :]).astype(f32)
    taps = gaussian_taps(p["ori_hist_blur_sigma"], 0.01)
    rad = f32(PATCH_RAD)
    ori = np.zeros((c, k1, k2, 3, 3), f32)
    valid = np.zeros((c, k1, k2), bool)
    if c == 0:
        return ori, valid
    at = lambda a: (a * rad + rad + f32(0.5)).astype(f32)  # noqa: E731
    v1, ok1, pos1 = hist_peaks(blurred_histograms(at(e[:, 0]), at(e[:, 1]), at(e[:, 2]), wgt, taps), k1)
    ok1 &= (v1 >= f32(p["ori_peak_threshold"]) * v1[:, :1]) & (v1 > 0)
    p1 = unit_or_x(pos1 - rad)
    ci, ki = np.nonzero(ok1)
    if not len(ci):
        return ori, valid
    er, p1r = e[ci], p1[ci, ki]
    par = np.einsum("rdv,rd->rv", er, p1r).astype(f32)
    perp = (er - par[:, None, :] * p1r[:, :, None]).astype(f32)
    perp = np.moveaxis(unit_or_x(np.moveaxis(perp, 1, 2)), 2, 1)
    v2, ok2, pos2 = hist_peaks(blurred_histograms(at(perp[:, 0]), at(perp[:, 1]), at(perp[:, 2]), wgt[ci], taps), k2)
    ok2 &= (v2 >= f32(p["ori_2nd_peak_threshold"]) * v2[:, :1]) & (v2 > 0)
    p2 = unit_or_x(pos2 - rad)
    p1b = p1r[:, None, :]
    p2 = unit_or_x(p2 - (p2 * p1b).sum(-1, keepdims=True, dtype=f32) * p1b)
    p1k = np.broadcast_to(p1b, p2.shape)
    ori[ci, ki] = np.stack([p1k, p2, np.cross(p1k, p2).astype(f32)], 2)
    valid[ci, ki] = ok2
    return ori, valid


def goh(patches: np.ndarray) -> np.ndarray:
    """[C, 64] rank-normalised GoH descriptors of raw patches."""
    c = len(patches)
    g = gradients(normalize(patches))
    mag = np.sqrt((g * g).sum(1, dtype=f32))
    obin = np.argmax(np.einsum("cgzyx,og->cozyx", g, _ORI_DIRS, optimize=True), axis=1)
    # spatial bins: voxels 0..4 in bin 0, 6..10 in bin 1, 5 shared equally
    sp = np.zeros((PATCH_DIM, 2), f32)
    sp[:5, 0] = 1.0
    sp[6:, 1] = 1.0
    sp[5] = 0.5
    onehot = (obin[:, None] == np.arange(8)[None, :, None, None, None]) * np.where(mag > 0, mag, f32(0.0))[:, None]
    hist = np.einsum("cozyx,za,yb,xd->cabdo", onehot.astype(f32), sp, sp, sp, optimize=True).reshape(c, 64).astype(f32)
    shifted = hist - hist.min(axis=1, keepdims=True)
    n = np.sqrt((shifted * shifted).sum(axis=1, keepdims=True, dtype=f32))
    d = shifted / np.where(n > 0, n, f32(1.0))
    ranks = np.empty_like(d)
    np.put_along_axis(ranks, np.argsort(d, axis=1, kind="stable"), np.arange(64, dtype=f32)[None], axis=1)
    return ranks


# ---------------------------------------------------------------------------
# One volume
# ---------------------------------------------------------------------------


def features(vol: np.ndarray, sift: Dict, descriptor: str, control: bool = False) -> dict:
    """The features of one [Z, Y, X] volume as a dict of numpy arrays
    (FIELDS). sift: configuration changes from the defaults (none of the
    benchmark's configurations has any); control: the TF32 blur."""
    p = dict(DEFAULTS, **sift)
    if set(p) != set(DEFAULTS):
        raise ValueError(f"unknown configuration keys {sorted(set(p) - set(DEFAULTS))}")
    if descriptor != "goh":
        raise ValueError(f"the reference computes GoH descriptors only, not {descriptor!r}")
    sig = [f32(s) for s in level_sigmas(p)]
    factor = float(2.0 ** (1.0 / p["blurs_per_octave"]))
    inc = [s * math.sqrt(factor * factor - 1.0) for s in level_sigmas(p)[:-1]]
    base = torch.from_numpy(np.ascontiguousarray(vol, f32))
    base = blur3d(base, math.sqrt(max(p["sigma_base"] ** 2 - p["sigma_init"] ** 2, 0.0)), p["blur_precision"], control)
    parts = []
    with torch.no_grad():
        for octave in range(octaves(vol.shape)):
            levels = [base]
            for j in range(1, len(sig)):
                levels.append(blur3d(levels[-1], inc[j - 1], p["blur_precision"], control))
            g = torch.stack(levels)
            dogs = g[:-1] - g[1:]
            base = subsample(levels[p["blurs_per_octave"]])
            parts.append(_octave(g.numpy(), dogs.numpy(), strict_extrema(dogs), sig, p, f32(2.0**octave)))
    out = {k: np.concatenate([q[k] for q in parts]) for k in FIELDS} if parts else None
    if out is None:
        out = dict(xyz=np.zeros((0, 3), f32), scale=np.zeros(0, f32), ori=np.zeros((0, 3, 3), f32),
                   eigs=np.zeros((0, 3), f32), info=np.zeros(0, np.uint32), desc=np.zeros((0, 64), f32))
    return out


def _octave(g: np.ndarray, dogs: np.ndarray, cand: np.ndarray, sig, p: dict, factor) -> dict:
    """The rows of one octave, its coordinates scaled by `factor`."""
    lvl, z, y, x, sign = cand.T
    _, zd, yd, xd = dogs.shape

    def d(dl, dz, dy, dx):
        return dogs[lvl + dl, z + dz, y + dy, x + dx]

    def along(step, c):  # the parabola through the centre and its neighbours one step away
        c = c.astype(f32)
        return parabola_vertex(d(*(-s for s in step)), d(0, 0, 0, 0), d(*step), c - f32(1.0), c, c + f32(1.0))

    fx, fy, fz = along((0, 0, 0, 1), x), along((0, 0, 1, 0), y), along((0, 1, 0, 0), z)
    sg = np.asarray(sig, f32)
    scale = f32(2.0) * parabola_vertex(d(-1, 0, 0, 0), d(0, 0, 0, 0), d(1, 0, 0, 0), sg[lvl - 1], sg[lvl], sg[lvl + 1])
    xyz = np.stack([fx + f32(0.5), fy + f32(0.5), fz + f32(0.5)], -1).astype(f32)
    rad = np.floor(f32(2.0) * scale + f32(2.0))[:, None]
    inside = ((xyz - rad >= 0) & (xyz + rad < np.array([xd, yd, zd], f32))).all(1)
    lvl, sign, xyz, scale = lvl[inside], sign[inside], xyz[inside], scale[inside]

    patches = np.zeros((len(lvl), PATCH_DIM, PATCH_DIM, PATCH_DIM), f32)
    for l in np.unique(lvl):
        s = lvl == l
        patches[s] = sample_patches(g[l], xyz[s], scale[s])
    pn = normalize(patches)
    eigs, eig_ori = eigen(pn)
    s = eigs.sum(1, dtype=f32)
    keep = (s * s * s < f32(p["eig_threshold"]) * eigs.prod(1, dtype=f32)) if p["eig_threshold"] >= 0 \
        else np.ones(len(eigs), bool)
    lvl, sign, xyz, scale, eigs, eig_ori, pn = (a[keep] for a in (lvl, sign, xyz, scale, eigs, eig_ori, pn))

    ori, valid = canonical(pn, p)
    c, k1, k2 = valid.shape
    valid = valid.reshape(c, k1 * k2)
    valid &= np.cumsum(valid, 1) <= p["max_orientations"]
    ci, si = np.nonzero(valid)
    rot = ori.reshape(c, k1 * k2, 3, 3)[ci, si]
    rpatch = np.zeros((len(ci), PATCH_DIM, PATCH_DIM, PATCH_DIM), f32)
    for l in np.unique(lvl[ci]):
        s = lvl[ci] == l
        rpatch[s] = sample_patches(g[l], xyz[ci][s], scale[ci][s], rot[s])

    peak = np.where(sign > 0, INFO_PEAK, 0).astype(np.uint32)
    return dict(
        xyz=np.concatenate([xyz, xyz[ci]]) * factor,
        scale=np.concatenate([scale, scale[ci]]) * factor,
        ori=np.concatenate([eig_ori, rot]),
        eigs=np.concatenate([eigs, eigs[ci]]),
        info=np.concatenate([peak, peak[ci] | INFO_REORIENT]).astype(np.uint32),
        desc=np.concatenate([goh(pn), goh(rpatch)]).astype(f32),
    )
