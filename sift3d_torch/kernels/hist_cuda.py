"""K3: blurred orientation histogram -> top-k strict peaks (CUDA kernel +
plain form).

Replaces the Pallas kernel ``sift3d.kernels.hist_pallas.
smooth_histogram_topk``; the CUDA source is ``csrc/hist_topk.cu``. The
output layout is the Pallas kernel's, so one consumer
(``sift3d_torch.pipeline.features.hist_tops``) serves both versions:
[C, k, 16] f32 with lane 0 the peak value (-inf = no peak), lanes 1-6 the
blurred histogram at x-1, x+1, y-1, y+1, z-1, z+1 and lane 7 the flat
position (z * 11 + y) * 16 + x. An empty slot sits at (1, 1, 1).

Points come at bin coordinates (bin i's centre at i), where the Pallas
kernel takes them + 0.5: the compiled JAX package folds that + 0.5 and the
interpolation's - 0.5 away, and only the folded form rounds as it does.

The plain version sums the histogram in the kernel's order (fused
multiply-adds over 128-point chunks, chunk sums added), which is also the
JAX package's CPU order, so all three agree to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sift3d_torch.core.numerics import fma
from sift3d_torch.kernels import cuda_lib
from sift3d_torch.kernels.gauss import band_from_taps
from sift3d_torch.kernels.patch import PATCH_DIM, local_peaks_3d
from sift3d_torch.kernels.resample import interp_bin

LANES = 16
CHUNK = 128  # points per partial sum (the kernel's shared-memory stage)


def hist_band(taps) -> np.ndarray:
    """[11, 11] zero-border blur band of the histogram: B[i, o] is the
    weight bin i gives output bin o."""
    return band_from_taps(np.asarray(taps, np.float32), PATCH_DIM)


def hist_topk_plain(cx, cy, cz, w, band, k: int) -> torch.Tensor:
    """cx, cy, cz, w: [C, V] f32 splat bin coordinates (bin i's centre at
    i) and weights; band [11, 11] f32 -> [C, k, 16] top-k peak rows."""
    c, v_total = cx.shape

    def factors(u):
        # splat (2 taps) then blur, per axis: w0 * B[i0] + (1 - w0) * B[i0 + 1]
        i0, w0 = interp_bin(u, PATCH_DIM)
        return w0[..., None] * band[i0] + (1.0 - w0)[..., None] * band[i0 + 1]

    fx, fy = factors(cx), factors(cy)
    fz = w[..., None] * factors(cz)
    hist = torch.zeros((c, PATCH_DIM, PATCH_DIM, PATCH_DIM), dtype=torch.float32, device=cx.device)
    # fused multiply-adds over each CHUNK points in order, chunk sums added
    for v0 in range(0, v_total, CHUNK):
        part = torch.zeros_like(hist)
        for v in range(v0, min(v0 + CHUNK, v_total)):
            inplane = fy[:, v, None, :, None] * fx[:, v, None, None, :]
            part = fma(fz[:, v, :, None, None].expand_as(part), inplane.expand_as(part), part)
        hist = hist + part

    pk = torch.where(local_peaks_3d(hist), hist, torch.full_like(hist, -torch.inf))
    vals, idx = torch.sort(pk.reshape(c, -1), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    valid = vals > -torch.inf
    one = torch.ones_like(idx)
    z = torch.where(valid, idx // (PATCH_DIM * PATCH_DIM), one)
    y = torch.where(valid, (idx // PATCH_DIM) % PATCH_DIM, one)
    x = torch.where(valid, idx % PATCH_DIM, one)
    b = (z * PATCH_DIM + y) * PATCH_DIM + x
    hflat = hist.reshape(c, -1)
    out = torch.zeros((c, k, LANES), dtype=torch.float32, device=cx.device)
    out[..., 0] = vals
    for lane, off in enumerate((-1, 1, -PATCH_DIM, PATCH_DIM, -PATCH_DIM**2, PATCH_DIM**2), 1):
        out[..., lane] = torch.gather(hflat, 1, b + off)
    out[..., 7] = ((z * PATCH_DIM + y) * LANES + x).to(torch.float32)
    return out


def hist_topk(cx, cy, cz, w, band, k: int) -> torch.Tensor:
    """K3: top-k blurred-histogram peaks (see hist_topk_plain)."""
    if cuda_lib.route(cx) == "plain":
        return hist_topk_plain(cx, cy, cz, w, band, k)
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz), ("w", w)):
        cuda_lib.require_cuda(t, name, torch.float32, 2)
        if t.shape != cx.shape or t.device != cx.device:
            raise ValueError(f"{name} must be {tuple(cx.shape)} on {cx.device}")
    cuda_lib.require_cuda(band, "band", torch.float32, 2)
    if band.shape != (PATCH_DIM, PATCH_DIM) or band.device != cx.device:
        raise ValueError(f"band must be [11, 11] on {cx.device}")
    if not 1 <= k <= PATCH_DIM**3:
        raise ValueError(f"k must be in [1, 1331], got {k}")
    c, v_total = cx.shape
    out = torch.empty((c, k, LANES), dtype=torch.float32, device=cx.device)
    if c == 0:
        return out
    cuda_lib.launch(
        "sift3d_hist_topk", cx, cy, cz, w, band, out, c, v_total, k, device=cx.device
    )
    hist_topk.launches += 1
    return out


hist_topk.launches = 0
