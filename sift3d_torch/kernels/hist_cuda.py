"""K3, K8, K9 and the fused canonical stage: orientation histograms (CUDA
kernels + plain forms).

K3 :func:`hist_topk` replaces the Pallas kernel ``sift3d.kernels.
hist_pallas.smooth_histogram_topk``: the blurred histogram's top-k strict
peaks. K8 :func:`splat_histogram_raw` replaces
``splat_histogram_raw`` (the unblurred trilinear splat) and K9
:func:`smooth_histogram_peaks` replaces ``smooth_histogram_peaks`` (the
blurred histogram and its strict-peak plane); neither has a caller on the
main path, as in the JAX package. All three are entries of
``csrc/hist_topk.cu``, one body that stops at the splat (K8), at the peak
plane (K9) or after the top-k (K3). :func:`smooth_histogram`, K8 followed
by the blur (K7), is the counterpart of ``features._smooth_histogram``.
:func:`canonical_orientations` runs the same body inside the fused
canonical stage (the main path's, on a CUDA tensor), whose plain version is
``sift3d_torch.pipeline.features.canonical_stage_plain``; K3 keeps its
entry point.

K3's output layout is the Pallas kernel's, so one consumer
(``sift3d_torch.pipeline.features.hist_tops``) serves both versions:
[C, k, 16] f32 with lane 0 the peak value (-inf = no peak), lanes 1-6 the
blurred histogram at x-1, x+1, y-1, y+1, z-1, z+1 and lane 7 the flat
position (z * 11 + y) * 16 + x. An empty slot sits at (1, 1, 1). K8 and K9
write [C, 11, 11, 11]: the Pallas kernels' padded [C, 128, 16] layout is a
TPU tiling artifact.

K3 and the ``*_bins`` entries take points at bin coordinates (bin i's
centre at i): the compiled JAX package folds the Pallas kernels' + 0.5 and
the interpolation's - 0.5 away, and only the folded form rounds as it
does. :func:`splat_histogram_raw`, :func:`smooth_histogram_peaks` and
:func:`smooth_histogram` take the JAX functions' 0.5-centred coordinates
and subtract 0.5 first, as ``hist_pallas._interp_coord_11`` does.

The plain versions sum the histogram in the kernel's order (fused
multiply-adds over 128-point chunks, chunk sums added), which is also the
JAX package's CPU order, so all three agree to the bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.gauss import band_from_taps
from sift3d_torch.kernels.gauss_cuda import blur3d
from sift3d_torch.kernels.patch import PATCH_DIM, local_peaks_3d
from sift3d_torch.kernels.resample import interp_bin

LANES = 16
CHUNK = 128  # points per partial sum (the kernel's shared-memory stage)


def hist_band(taps) -> np.ndarray:
    """[11, 11] zero-border blur band of the histogram: B[i, o] is the
    weight bin i gives output bin o."""
    return band_from_taps(np.asarray(taps, np.float32), PATCH_DIM)


def splat_blur_plain(cx, cy, cz, w, band) -> torch.Tensor:
    """cx, cy, cz, w: [C, V] f32 splat bin coordinates (bin i's centre at
    i) and weights; band [11, 11] f32 -> the [C, 11, 11, 11] splat blurred
    by the band (the identity band: the raw splat)."""
    c, v_total = cx.shape

    def factors(u):
        # splat (2 taps) then blur, per axis: w0 * B[i0] + (1 - w0) * B[i0 + 1]
        i0, w0 = interp_bin(u, PATCH_DIM)
        return w0[..., None] * band[i0] + (1.0 - w0)[..., None] * band[i0 + 1]

    fx, fy = factors(cx), factors(cy)
    fz = w[..., None] * factors(cz)
    hist = torch.zeros((c, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=cx.device)
    # Along each axis a point's factors are exact zeros outside the
    # W = 2 + 2 * reach bins from (its lower bin - reach), reach the band's
    # half-width. A multiply-add of a zero product leaves a sum (never -0)
    # as it is, so each point updates only its W^3 box, with the bits of
    # the whole (the kernel's warps skip zero products alike). A non-finite
    # weight turns zero factors into NaN products: then every bin takes
    # every point.
    nz = torch.nonzero(band)
    reach = int((nz[:, 0] - nz[:, 1]).abs().max()) if len(nz) else 0
    width = 2 + 2 * reach
    if width >= PATCH_DIM or not bool(torch.isfinite(w).all()):
        return _splat_full(fx, fy, fz, hist)
    span, n = torch.arange(width, device=cx.device), width**3

    def window(u, f):
        """[C, V, W] bins of each point's box along one axis, and the
        factors there."""
        lo = torch.clamp(interp_bin(u, PATCH_DIM)[0] - reach, 0, PATCH_DIM - width)
        idx = lo[..., None] + span
        return idx, torch.gather(f, 2, idx)

    (ix, wx), (iy, wy), (iz, wz) = window(cx, fx), window(cy, fy), window(cz, fz)
    flat = hist.reshape(c, PATCH_DIM**3)
    # fused multiply-adds over each CHUNK points in order, chunk sums added
    for v0 in range(0, v_total, CHUNK):
        part = torch.zeros_like(flat)
        for v in range(v0, min(v0 + CHUNK, v_total)):
            box = ((iz[:, v, :, None, None] * PATCH_DIM + iy[:, v, None, :, None]) * PATCH_DIM
                   + ix[:, v, None, None, :]).reshape(c, n)
            inplane = (wy[:, v, :, None] * wx[:, v, None, :])[:, None].expand(c, width, width, width)
            fzv = wz[:, v, :, None, None].expand(c, width, width, width)
            part.scatter_(1, box, fma_exact(fzv.reshape(c, n), inplane.reshape(c, n), torch.gather(part, 1, box)))
        flat = flat + part
    return flat.reshape(hist.shape)


def _splat_full(fx, fy, fz, hist):
    """splat_blur_plain over every bin for every point."""
    for v0 in range(0, fx.shape[1], CHUNK):
        part = torch.zeros_like(hist)
        for v in range(v0, min(v0 + CHUNK, fx.shape[1])):
            inplane = fy[:, v, None, :, None] * fx[:, v, None, None, :]
            part = fma_exact(fz[:, v, :, None, None].expand_as(part), inplane.expand_as(part), part)
        hist = hist + part
    return hist


def peak_plane(hist: torch.Tensor) -> torch.Tensor:
    """hist where a strict interior 26-neighbour peak, -inf elsewhere."""
    return torch.where(local_peaks_3d(hist), hist, torch.full_like(hist, -torch.inf))


def peak_rows(hist: torch.Tensor, pk: torch.Tensor, k: int) -> torch.Tensor:
    """K3's [C, k, 16] rows from a histogram and its peak plane: the k
    largest peaks, the lowest flat index first on ties."""
    c = hist.shape[0]
    # the width spelled out: -1 is ambiguous for C = 0 (no live primary in an octave)
    vals, idx = torch.sort(pk.reshape(c, PATCH_DIM**3), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    valid = vals > -torch.inf
    one = torch.ones_like(idx)
    z = torch.where(valid, idx // (PATCH_DIM * PATCH_DIM), one)
    y = torch.where(valid, (idx // PATCH_DIM) % PATCH_DIM, one)
    x = torch.where(valid, idx % PATCH_DIM, one)
    b = (z * PATCH_DIM + y) * PATCH_DIM + x
    hflat = hist.reshape(c, PATCH_DIM**3)
    out = torch.zeros((c, k, LANES), dtype=torch.float32, device=hist.device)
    out[..., 0] = vals
    for lane, off in enumerate((-1, 1, -PATCH_DIM, PATCH_DIM, -PATCH_DIM**2, PATCH_DIM**2), 1):
        out[..., lane] = torch.gather(hflat, 1, b + off)
    out[..., 7] = ((z * PATCH_DIM + y) * LANES + x).to(torch.float32)
    return out


def hist_topk_plain(cx, cy, cz, w, band, k: int) -> torch.Tensor:
    """cx, cy, cz, w: [C, V] f32 splat bin coordinates and weights; band
    [11, 11] f32 -> [C, k, 16] top-k peak rows."""
    hist = splat_blur_plain(cx, cy, cz, w, band)
    return peak_rows(hist, peak_plane(hist), k)


def _check_points(cx, cy, cz, w, band) -> None:
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz), ("w", w)):
        cuda_lib.require_cuda(t, name, torch.float32, 2)
        if t.shape != cx.shape or t.device != cx.device:
            raise ValueError(f"{name} must be {tuple(cx.shape)} on {cx.device}")
    cuda_lib.require_cuda(band, "band", torch.float32, 2)
    if band.shape != (PATCH_DIM, PATCH_DIM) or band.device != cx.device:
        raise ValueError(f"band must be [11, 11] on {cx.device}")


def hist_topk(cx, cy, cz, w, band, k: int) -> torch.Tensor:
    """K3: top-k blurred-histogram peaks (see hist_topk_plain)."""
    if cuda_lib.route(cx) == "plain":
        return hist_topk_plain(cx, cy, cz, w, band, k)
    _check_points(cx, cy, cz, w, band)
    if not 1 <= k <= PATCH_DIM**3:
        raise ValueError(f"k must be in [1, 1331], got {k}")
    c, v_total = cx.shape
    out = torch.empty((c, k, LANES), dtype=torch.float32, device=cx.device)
    if c == 0:
        return out
    cuda_lib.launch(
        "sift3d_hist_topk", cx, cy, cz, w, band, out, c, v_total, k, device=cx.device
    )
    return out


MAX_SLOTS = PATCH_DIM**3 // LANES  # 83: the fused kernels keep a row's top-k in its patch's place


def canonical_orientations(pn, band, k1: int, k2: int, thr1: float, thr2: float, kvalid=None):
    """The fused canonical stage (``sift3d_canonical``: two launches, one
    block a row, then one a (row, primary) slot; see ``csrc/hist_topk.cu``):
    ``features.canonical_stage_plain`` on a CUDA tensor, bit for bit.

    pn [C, 11, 11, 11] f32 normalized patches; band [11, 11] f32 in host
    memory (passed by value); k1, k2 in [1, 83] primary and secondary
    peaks; thr1, thr2 their thresholds; kvalid: optional [C] bool survivor
    mask. Returns (ori [C, k1, k2, 3, 3], ori_valid [C, k1, k2]). One call
    is one launch of ``sift3d_canonical`` (the pair) and waits for nothing."""
    if not (1 <= k1 <= MAX_SLOTS and 1 <= k2 <= MAX_SLOTS):
        raise ValueError(f"k1 and k2 must be in [1, {MAX_SLOTS}], got {k1} and {k2}")
    if pn.dtype != torch.float32 or pn.shape[1:] != (PATCH_DIM,) * 3:
        raise ValueError(f"pn must be [C, 11, 11, 11] float32, got {tuple(pn.shape)} {pn.dtype}")
    c = pn.shape[0]
    if kvalid is not None and (kvalid.dtype != torch.bool or kvalid.shape != (c,)):
        raise ValueError(f"kvalid must be [{c}] bool, got {tuple(kvalid.shape)} {kvalid.dtype}")
    if (band.device.type != "cpu" or band.dtype != torch.float32 or band.shape != (PATCH_DIM, PATCH_DIM)
            or not band.is_contiguous()):
        raise ValueError(f"band must be a contiguous [11, 11] float32 tensor in host memory, got "
                         f"{tuple(band.shape)} {band.dtype} on {band.device}")
    cuda_lib.require_cuda(pn, "pn", torch.float32, 4)
    dev = pn.device
    if kvalid is not None:
        kvalid = kvalid.contiguous()
        cuda_lib.require_cuda(kvalid, "kvalid", torch.bool, 1)
        if kvalid.device != dev:
            raise ValueError(f"kvalid must be on {dev}")
    ori = torch.empty((c, k1, k2, 3, 3), dtype=torch.float32, device=dev)
    ori_valid = torch.empty((c, k1, k2), dtype=torch.bool, device=dev)
    if c == 0:
        return ori, ori_valid
    p1 = torch.empty((c, k1, 3), dtype=torch.float32, device=dev)
    live = torch.empty((c, k1), dtype=torch.bool, device=dev)
    cuda_lib.launch("sift3d_canonical", pn, kvalid, band, p1, live, ori, ori_valid, float(thr1), float(thr2),
                    c, k1, k2, device=dev)
    return ori, ori_valid


@functools.lru_cache(maxsize=None)
def _identity_band(device: torch.device) -> torch.Tensor:
    return torch.eye(PATCH_DIM, dtype=torch.float32, device=device)


def splat_histogram_raw_plain(cx, cy, cz, w) -> torch.Tensor:
    """The raw trilinear splat [C, 11, 11, 11] of points at bin
    coordinates: the accumulation with the identity as the band."""
    return splat_blur_plain(cx, cy, cz, w, _identity_band(cx.device))


def smooth_histogram_peaks_plain(cx, cy, cz, w, band):
    """(blurred histogram, peak plane) of points at bin coordinates."""
    hist = splat_blur_plain(cx, cy, cz, w, band)
    return hist, peak_plane(hist)


def splat_histogram_raw_bins(cx, cy, cz, w) -> torch.Tensor:
    """K8 at bin coordinates (see splat_histogram_raw_plain): K3's
    accumulation with the identity as the band."""
    if cuda_lib.route(cx) == "plain":
        return splat_histogram_raw_plain(cx, cy, cz, w)
    band = _identity_band(cx.device)
    _check_points(cx, cy, cz, w, band)
    c, v_total = cx.shape
    hist = torch.empty((c, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=cx.device)
    if c == 0:
        return hist
    cuda_lib.launch("sift3d_splat_histogram_raw", cx, cy, cz, w, band, hist, c, v_total, device=cx.device)
    return hist


def smooth_histogram_peaks_bins(cx, cy, cz, w, band):
    """K9 at bin coordinates: (the blurred histogram, its peak plane), each
    [C, 11, 11, 11] (see smooth_histogram_peaks_plain)."""
    if cuda_lib.route(cx) == "plain":
        return smooth_histogram_peaks_plain(cx, cy, cz, w, band)
    _check_points(cx, cy, cz, w, band)
    c, v_total = cx.shape
    hist = torch.empty((c, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=cx.device)
    pk = torch.empty_like(hist)
    if c == 0:
        return hist, pk
    cuda_lib.launch(
        "sift3d_smooth_histogram_peaks", cx, cy, cz, w, band, hist, pk, c, v_total, device=cx.device
    )
    return hist, pk


def _bins(*coords):
    # the 0.5-centre convention -> bin coordinates (hist_pallas._interp_coord_11)
    return [(u - 0.5).contiguous() for u in coords]


def splat_histogram_raw(cx, cy, cz, w) -> torch.Tensor:
    """K8: unblurred trilinear splat histograms [C, 11, 11, 11] of [C, V]
    points at 0.5-centred coordinates (``hist_pallas.splat_histogram_raw``)."""
    return splat_histogram_raw_bins(*_bins(cx, cy, cz), w.contiguous())


def smooth_histogram_peaks(cx, cy, cz, w, band):
    """K9: (blurred histogram, strict-peak plane), each [C, 11, 11, 11], of
    [C, V] points at 0.5-centred coordinates
    (``hist_pallas.smooth_histogram_peaks``); band [11, 11]."""
    return smooth_histogram_peaks_bins(*_bins(cx, cy, cz), w.contiguous(), band)


def smooth_histogram(cx, cy, cz, w, blur_sigma: float) -> torch.Tensor:
    """The blurred histogram [C, 11, 11, 11]: K8, then the zero-border
    blur (K7) at blur_sigma with the histograms' 0.01 tap rule
    (``features._smooth_histogram``, ``hist_pallas.smooth_histogram_pallas``)."""
    return blur3d(splat_histogram_raw(cx, cy, cz, w), blur_sigma, 0.01)
