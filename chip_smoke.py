#!/usr/bin/env python3
"""Drive the PyTorch port (sift3d_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card (nvidia-smi name and power limit), PyTorch and CUDA versions,
     the seconds the hand-written kernels took to build (nvcc, sm_90a) and
     the native .key I/O library (g++, io/native.py), the
     registers, shared memory and spills of K7's, K3/K8/K9's, the fused
     canonical stage's, K1/K6's, the
     fused K2's and K4's (GoH and BRIEF), K10's, K11's and M1-M3's kernels from the
     build's nvcc.log, and a warning naming any kernel that spills; the int8
     tensor-core instructions (IMMA) in M1's and M2's int8 kernels from
     cuobjdump -sass, which must hold some;
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at main-path shapes — K7 (the blur) on the full-size initial and
     level-5 blurs, the -2+ initial and level-5 blurs (364x436x364) and
     4096 BRIEF patches, also exactly against the plain version on the CPU
     (not at the -2+ shapes); K10 (the -2+ upsample, double_size_batch) on
     a [16, 182, 218, 182] batch (a -2+ sub-batch of T1 volumes) against
     the plain double_size chain volume by volume, exactly, its bound 36
     bytes a voxel of the input; K11 (the -w resample,
     isotropic_resample_batch) on a [32, 128, 256, 256] batch at 1 x 1 x
     1.25 mm (a -w sub-batch of OASIS-1 scans, grid 160x256x256) and on
     edge shapes (length-1, odd and even axes, factors 1.25 to 3.0 on each
     axis, NaN, infinities and signed zeros) against the plain
     isotropic_resample chain volume by volume, bit for bit, its bound 8
     bytes a voxel (4 read, 4 written); K1 on the octave-0 Gaussian stack of the T1
     grid, of the -2+ grid ([6, 364, 436, 364], 1.39 GB) and of the -2-
     grid, K6 on the T1 octave-0 DoGs and on one -2+ shard's one-plane-halo
     DoG slab, and the fused K2, K3, the fused canonical stage (both
     orientation histograms, their peaks and the frames, bit for bit the
     plain canonical_stage_plain on every entry of ori and ori_valid) and
     K4 on the rows each of those octaves produces (T1's tiled to 4096),
     K8 and K9 on T1's primary-histogram rows, whose K9 top-k must equal
     K3 — with the max abs difference, the tolerance,
     median milliseconds of both (one call between two CUDA events, and
     a call's share of a burst of 20, which leaves out the host's launch
     gap), the bound (the least time the card could take: bytes over 3.35
     TB/s or f32 FLOPs over 67 TFLOP/s, whichever is larger) and, where one
     PyTorch call computes the same function, that call's milliseconds (the
     fused K2, the fused canonical stage and K4, which no one PyTorch call
     computes, beside the device time of the eager chain each replaces on
     the same rows: the plain refinement, sampler and eigen test for K2,
     the plain stage around K3 for the canonical stage, K4's patch mode and the
     eager GoH descriptor for K4, K4's patch mode and the eager BRIEF
     descriptor for the fused BRIEF kernels rotated_brief and brief, each
     on T1's rows with the three variants); K7
     also with its launch geometry, its GB/s and the times of other
     geometries on the T1 and -2+ grids and (xy + z against the
     small-volume kernel) on the BRIEF batch; K1 on the T1 and -2+ stacks
     and K6 on their DoGs and slab at every launch extrema_launch_geometry
     can choose, each exact, with its times beside the chosen one; then
     edge shapes, each exact:
     K7 on volumes thinner than 2r + 1 along z, y and x, a 37x75x61 volume,
     a batch of three 91x109x91 volumes and every radius 1..8 (against the
     plain blur on the CPU), on the deepest T1 octave (5x6x5, against the
     fma chain in numpy), K3, K8 and K9 on rows with V in {1, 127, 128,
     129, 485}, a zero-weight row and two tied peaks, K1 and K6 (each a
     batch of three) at every launch on extents of 3 and 4 along z, y and x, a
     37x75x61 volume and the 5x6x5 octave, with plateaus, ties, +-0, +-inf
     and NaN planted on the seams of tiles, warps and z runs, the fused K2
     on rows whose patch is constant (norm 0, a zero tensor), a ramp along
     x (a diagonal tensor, r at +-1), a bowl (nearly triple-degenerate) or
     a ramp with a faint second slope (a nearly degenerate pair), from the
     whole volume and from a Z slab (gz0 > 0), and the fused K4 on flat
     patches (all 64 bins tied), rows at scales above 8.80, rows reaching
     outside the volume in x and slab rows, the fused BRIEF kernels on the
     same rows and patches with every variant and pair table, on a NaN patch
     and on rows whose level is out of range (NaN patches); and the batched
     calls of
     extract_features_many: K1 on the [4, 6, 182, 218, 182] octave-0 stacks
     of phase 12's first four volumes, the fused K2 on their candidate
     union (volume index vi) and the fused K4 on its reoriented rows over
     the flattened [24, 182, 218, 182] stack, then the three on a batch
     whose first volume (zeros) has no candidate, each exact against its
     plain version and against per-volume launches;
  3. extract_features on the 182x218x182 blob texture (the 1 mm MNI T1
     grid) on cuda:0: each span's host and stream milliseconds (the
     tracer's record, which waits for nothing), feature counts, and every
     kernel's launch count in that run (each must be > 0; the fused
     canonical stage once a canonical span) and the canonical_rows and
     reoriented_rows counters; then K3's, K8's and K9's own path (they have
     no caller on the main path): their entry points hist_topk,
     smooth_histogram and smooth_histogram_peaks on T1's primary-histogram
     points, and the launches there; and K4's patch mode
     (no caller on a path since the BRIEF path is fused) through its entry
     point on the extraction's reoriented rows;
  4. the same call not recorded (host wall of five calls) and once
     under torch.profiler: device busy milliseconds, the trace's span, the
     idle share against both (the profiler slows the host, so the share
     against the unprofiled wall is the one a user sees), the launch calls
     in each stage (the canonical stage's at most CANONICAL_LAUNCHES a
     call: the fused pair and reoriented_slots), and the device
     milliseconds of the costliest kernel names in the trace;
  5. the port on the card against the port on the CPU on
     synthetic_volume(64): equal counts, locations, scales, orientations
     and eigenvalues (max difference 0.0), identical descriptors on every
     row;
  6. the CLI with no flags (it runs on cuda:0) on that volume as NIfTI,
     against the CLI on the CPU: every main-path kernel launched, the two
     .key files byte-identical;
  7. the CLI on the card at full width with each resampling flag and each
     descriptor flag: -2+ on the 182x218x182 texture (grid 364x436x364),
     -w and -ws on every other z-plane of it at 1x1x2 mm with a rotated
     qform and sform (grid 182x218x182), -2-, -b, -br and -bn on it: wall
     milliseconds of two calls, .key rows, and every kernel's launches (the
     fused K4 on the GoH flags, the fused BRIEF kernels on -b, -br and
     -bn, K10 on -2+ alone, K11 once a call on -w and -ws alone, K4's patch
     mode on none); then the descriptors stage of
     extract_features with GoH and each BRIEF variant under torch.profiler:
     its launch calls and device ms;
  8. the CLI on the card against the CLI on the CPU for every flag, on the
     64^3-grid volumes of tests/test_torch_cli_flags.py: equal rows,
     locations and scales, identical descriptors, byte-identical .key files,
     and for --debug-pgm the same PGM files byte for byte;
  9. Z-sharded extraction (extract_features_spatial, the CLI's --spatial)
     on a 4-shard mesh on cuda:0, on the -2+ grid (prescale "double"; the
     2 GiB rule shards octave 0) and on the T1 grid with 3 sharded octaves (halos relayed
     over several shards), against extract_features on the card: the
     sharded octaves' gathered Gaussian stacks and masks bit-equal, equal
     counts, locations, scales, flags, orientations, eigenvalues and
     descriptors, the -2+ rows equal to phase 7's; wall ms
     beside extract_features' walls, device peak memory and each shard's
     working set, and the launches
     (K6 once per shard in every sharded octave, K1 once per tail octave,
     K7, the fused K2, the fused canonical stage and the fused K4 > 0); then spatial on the card
     against spatial on the CPU on synthetic_volume(64) (equal rows,
     orientations and descriptors), and over every card when there are two
     or more;
 10. featmatch --all-to-all at full width on the card: 32 volumes on the
     182x218x182 grid (image 0 the blob texture, images 1-31 copies rolled
     by distinct integer shifts of at most 4 voxels plus seeded noise),
     extracted on the card and written as .key files, matched twice: the
     walls, [ms, launches of M1-M3] by stage (read, ratio_match and hough,
     the pairwise path, and group_vote), every pair's translation within 1
     voxel of its shift and its scale within 5% of 1; M3 launched twice in
     the hough stage (the scores and the inlier masks of all 31 pairs), the
     stage's ms and its device ms from one profiled call; the 32 .key files
     written through the native writer (io/native.py, g++) and through its
     plain Python version, byte-identical, with each route's ms a file; one
     more call with the plain .key reader and writer and the plain match
     files: its read and write stage ms beside the native call's, the
     .update.key (write_key) and match-file (write_matches) ms a pair of
     both, and its output files byte-identical to the native call's; M2's
     int8 route launched on featmatch's .key rows and its f32 route not;
     then M1's and M2's f32 routes through their entry points knn_search
     and ratio_match on float rows;
 11. the featmatch CLI on the card against the CLI on the CPU for every
     flag set of tests/test_torch_featmatch_cli.py and --refine, on its
     40^3 fixtures: every output file byte-identical;
 12. batched extraction (extract_features_many) on phase 10's 32 volumes,
     the first B for B in 1, 4, 8, 16 and 32: every volume's features equal
     extract_features on it alone, bit for bit; for each B the median wall
     of 5 calls, volumes/s, device busy and launch calls a volume and the
     idle share from one torch.profiler trace, the device peak, and the
     launches a batch of K7, K1 (once per octave), the fused K2, the fused
     canonical stage, the fused K4 and goh; then a mixed batch (a T1-grid volume, zeros, a -2-
     grid volume) on the card against the same batch on the CPU, exact.
Phase 2 also holds the matching kernels against their plain versions,
exactly, with the same times, bounds and yardsticks: M1 (kNN, k = 5) on
its int8 route over 48,000 rows all to all (the extraction's GoH rows
tiled, rows from a 4-letter alphabet, 67-column -g rows) and on a quarter
shard of 12,000 queries (the database cut into slices, then merged), and on
its f32 route on 48,000 float rows (yardstick torch.cdist + torch.topk; the
route and the launches printed), M2 on 31 stacked query sets against a
969-row database on its int8 route and, on the same rows plus 0.25, its f32
route (yardstick torch.cdist + the eager closed form; the route, the
launches and the kernel's own device ms printed), M2 on both routes at the
edge shapes D in {2, 3, 127, 128, 129, 969, 9000} on tie-heavy rows, M3's
scores (each hypothesis formed in the kernel from its match) on stacks of 31
pairs of 1000 and of 3000 matches (beside 31 single-pair launches) and at
M = 1500 and 3000, and its inlier masks with the winners' rotations and
scales on both stacks' winners, bit for bit (beside the device time and
launches of the eager chunked scorer and mask).
Then the kernel table as one JSON line, the card line, and last the
result line. Any failure raises and exits non-zero; without a CUDA card,
or without the sift3d_torch package beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FULL_DIMS = (182, 218, 182)
# an OASIS-1 raw MP-RAGE scan: host [Z, Y, X] and voxel size (dx, dy, dz) mm
OASIS_DIMS, OASIS_MM = (128, 256, 256), (1.0, 1.0, 1.25)
MIN_ROWS = 4096
REPS = 10
CANONICAL_LAUNCHES = 24  # launch calls a canonical span, at most: the fused pair and reoriented_slots


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    """Median device milliseconds of fn() over reps runs (after one warm-up),
    timed with CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device milliseconds a call of fn() in a burst of n back-to-back calls
    (median of reps bursts, CUDA events around each): the device time
    without the host's launch gap that a single timed call includes."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def at_least(rows, n: int):
    """Row tensors tiled up to >= n rows (timing at a realistic row count);
    at least once."""
    import torch

    if rows[0].shape[0] == 0:
        raise AssertionError("no rows to hold a kernel against its plain version on")
    reps = max(1, -(-n // rows[0].shape[0]))
    return [torch.cat([t] * reps).contiguous() for t in rows]


def max_abs(a, b) -> float:
    """Largest |a - b| over the finite values; inf where the two differ in
    where they are NaN or in a non-finite value."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    a, b = torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)
    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(a[~both], b[~both]):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense


def bound(n_bytes: float, flops: float, int8_ops: float = 0.0):
    """(least ms the card could take, "bytes" or "operations"): the largest
    of the bytes over the memory rate, the f32 FLOPs over their peak and
    the int8 tensor-core operations over theirs."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, int8_ops / INT8_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def touched_voxels(shape, lvl, x, y, z) -> int:
    """Distinct voxels of a [L, Z, Y, X] stack that 2-tap trilinear reads at
    continuous coordinates x, y, z ([R, P]) of level lvl [R] touch: what a
    sampler must read at least once."""
    import itertools

    import torch

    from sift3d_torch.kernels.resample import interp_coord

    _, zd, yd, xd = shape
    ix, _ = interp_coord(x, xd)
    iy, _ = interp_coord(y, yd)
    iz, _ = interp_coord(z, zd)
    base = ((lvl.to(torch.int64)[:, None] * zd + iz) * yd + iy) * xd + ix
    offs = torch.tensor(
        [(dz * yd + dy) * xd + dx for dz, dy, dx in itertools.product((0, 1), repeat=3)],
        device=base.device,
    )
    return int(torch.unique((base[..., None] + offs).reshape(-1)).numel())


def patch_points(lvl, centers, scales, oris=None):
    """The (x, y, z) sample coordinates [R, 1331] of 11^3 patches, identity
    or rotated (the samplers' grid)."""
    import torch

    from sift3d_torch.kernels.patch import invert_3x3, patch_grid

    grid = torch.from_numpy(patch_grid()).to(centers.device)  # [P, (x, y, z)]
    fac = (2.0 * scales / 5.0)[:, None]
    if oris is None:
        return [grid[:, i] * fac + centers[:, i, None] for i in range(3)]
    inv = invert_3x3(oris)
    return [(inv[:, i, 0, None] * grid[:, 0] + inv[:, i, 1, None] * grid[:, 1]
             + inv[:, i, 2, None] * grid[:, 2]) * fac + centers[:, i, None] for i in range(3)]


# The fused kernels' fixed bytes and least f32 operations per row; a
# comparison (a maximum, a minimum, a rank) is not counted. The fused K2
# reads the candidate's level and voxel (int64) and writes xyz, scale, pn,
# eigs, ori and two flags. Its operations: the sampler's 21 per point and 5
# per point to normalize (a sum, a difference, a square, a sum, a quotient);
# at the 485 points of the sphere mask, which lie inside the zero gradient
# border, 3 differences, 6 tensor products and 6 sums; about 450 for the
# refinement and the eigensolver. The GoH descriptor of a patch: 5 per point
# to normalize, the mean's quotient and the norm's root; at the 9^3 interior
# points (the border's gradients are 0 and add nothing), 3 differences, the
# magnitude (3 products, 2 sums, a root) and the 4 distinct cube-corner dots
# up to sign (6 sums); the splat, one product of the magnitude and a bin's
# weight (a constant of the position) and one sum for each spatial bin a
# point reaches: 10 an axis over the 9 interior positions, since position 5
# splits between both bins; then per bin a difference, a square, a sum and
# a quotient, and the norm's root.
GATHER_EIG_ROW_BYTES = 8 + 24 + 12 + 4 + 4 * 1331 + 12 + 36 + 2
GATHER_EIG_ROW_FLOPS = (21 + 5) * 1331 + 15 * 485 + 450
GOH_ROW_FLOPS = 5 * 1331 + 2 + 15 * 9**3 + 2 * 10**3 + 4 * 64 + 1


@functools.cache
def brief_row_flops(method: int, sigma: float, variant: str) -> int:
    """The least f32 operations of one row of the fused BRIEF kernel after
    its sampler: 5 a point to normalize, the mean's quotient and the norm's
    root; the pre-blur's multiply and add for each tap in range, of the z
    pass at the 128 pair endpoints, of the y pass at the points those read
    and of the x pass at the points the y pass reads; a difference a pair,
    and NRRIEF's quotient."""
    import numpy as np

    from sift3d_torch.kernels import descriptor
    from sift3d_torch.kernels.gauss import gaussian_kernel_1d

    r = len(gaussian_kernel_1d(sigma, 0.01)) // 2
    p, q = descriptor.brief_pair_table(method)
    ends = {(int(x), int(y), int(z)) for x, y, z in np.concatenate([p, q])}

    def taps(o):
        return min(10, o + r) - max(0, o - r) + 1

    y_pts = {(x, y, z2) for x, y, z in ends for z2 in range(max(0, z - r), min(10, z + r) + 1)}
    x_pts = {(x, y2, z) for x, y, z in y_pts for y2 in range(max(0, y - r), min(10, y + r) + 1)}
    blur = sum(taps(z) for _, _, z in ends) + sum(taps(y) for _, y, _ in y_pts) + sum(taps(x) for x, _, _ in x_pts)
    return 5 * 1331 + 2 + 2 * blur + 64 + (64 if variant == "nrrief" else 0)


def touched_dogs(shape, lvl, zyx) -> int:
    """Distinct voxels of a [5, Z, Y, X] DoG stack that the refinement of
    candidates (lvl [R], zyx [R, 3]) reads: the centre, its six neighbours
    and the two levels around it."""
    import torch

    _, zd, yd, xd = shape
    offs = torch.tensor([(0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 0, -1), (0, 0, 1, 0), (0, 0, -1, 0),
                         (0, 1, 0, 0), (0, -1, 0, 0), (1, 0, 0, 0), (-1, 0, 0, 0)], device=zyx.device)
    pts = torch.cat([lvl[:, None], zyx], dim=1)[:, None, :] + offs  # [R, 9, (l, z, y, x)]
    flat = ((pts[..., 0] * zd + pts[..., 1]) * yd + pts[..., 2]) * xd + pts[..., 3]
    return int(torch.unique(flat).numel())


def chain_time(fn) -> dict:
    """The eager chain a fused kernel replaces, on the same rows: the median
    ms of single calls, a call's share of a burst of 5, and the device busy
    ms and launch calls of one call under torch.profiler."""
    out = dict(ms=median_ms(fn, 5), b2b_ms=burst_ms(fn, n=5, reps=3), device_ms=None, launches=None)
    prof = device_profile(fn)
    if prof is not None:
        out.update(device_ms=prof[0], launches=prof[3])
    return out


def grid_sample_call(gstack, lvl, centers, scales, oris=None):
    """One torch.nn.functional.grid_sample call that samples the same 11^3
    patches (trilinear, border-saturating, voxel centres at i + 0.5) on all
    levels of the stack; the caller picks each row's level. The library
    yardstick of K2 and K4 (it reads 0 at no x, unlike K4's quirk)."""
    import torch

    _, zd, yd, xd = gstack.shape
    r = lvl.shape[0]
    x, y, z = patch_points(lvl, centers, scales, oris)
    norm = torch.stack([2.0 * x / xd - 1.0, 2.0 * y / yd - 1.0, 2.0 * z / zd - 1.0], dim=-1)
    grid = norm.reshape(1, r * 11, 11, 11, 3).contiguous()
    inp = gstack[None]
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="border", align_corners=False
    )


def splat_index_add_call(cx, cy, cz, w):
    """One index_add_ that accumulates the raw splat (8 trilinear corners
    per point, indices and weights precomputed): K8's library yardstick."""
    import itertools

    import torch

    from sift3d_torch.kernels.resample import interp_bin

    c = cx.shape[0]
    (ix, wx), (iy, wy), (iz, wz) = (interp_bin(u, 11) for u in (cx, cy, cz))
    flat, vals = [], []
    for dz, dy, dx in itertools.product((0, 1), repeat=3):
        f = (torch.arange(c, device=cx.device)[:, None] * 11 + iz + dz) * 121 + (iy + dy) * 11 + ix + dx
        flat.append(f)
        vals.append(w * (wz if dz == 0 else 1 - wz) * (wy if dy == 0 else 1 - wy) * (wx if dx == 0 else 1 - wx))
    flat, vals = torch.cat(flat, dim=1).reshape(-1), torch.cat(vals, dim=1).reshape(-1)
    return lambda: torch.zeros(c * 1331, device=cx.device).index_add_(0, flat, vals)


def conv3d_call(vol, sigma, min_value):
    """One torch.nn.functional.conv3d with the dense separable product of
    the taps, zero padding, TF32 off: K7's library yardstick."""
    import torch

    from sift3d_torch.kernels.gauss_cuda import device_taps

    taps = device_taps(float(sigma), float(min_value), vol.device)
    r = taps.shape[0] // 2
    weight = (taps[:, None, None] * taps[None, :, None] * taps[None, None, :])[None, None].contiguous()
    inp = vol.reshape((-1, 1) + tuple(vol.shape[-3:]))
    torch.backends.cudnn.allow_tf32 = False
    return lambda: torch.nn.functional.conv3d(inp, weight, padding=r)


def blur_rate(x, sigma, min_value) -> str:
    """K7's launch for x, its median ms and the achieved GB/s (each voxel
    read once and written once)."""
    from sift3d_torch.kernels import gauss_cuda

    shape = (1, *x.shape) if x.ndim == 3 else tuple(x.shape)
    r = gauss_cuda.host_taps(float(sigma), float(min_value)).shape[0] // 2
    g = gauss_cuda.blur_launch_geometry(shape, r, gauss_cuda.sm_count(x.device))
    ms = median_ms(lambda: gauss_cuda.blur3d(x, sigma, min_value))
    return f"r {r}, launch {json.dumps(g)}; kernel {ms!r} ms, {8 * x.numel() / ms / 1e6!r} GB/s"


def fma_f32(a, b, c):
    """The f32 fma of f32 numpy arrays, rounded once: the f64 product is
    exact, and a two-sum's error term settles the f64 sums that fall on a
    midpoint between two f32 values."""
    import numpy as np

    p, c64 = a.astype(np.float64) * b.astype(np.float64), c.astype(np.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    n = np.nextafter(r, np.where(s > rd, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32))
    nd = n.astype(np.float64)
    take_n = (s != rd) & (s == (rd + nd) * 0.5) & (err != 0) & ((err > 0) == (nd > rd))
    return np.where(take_n, n, r)


def fma_chain_blur3d(v, taps):
    """The blur csrc/blur3d.cu defines, in numpy: x pass, y pass, z pass;
    output o of a pass is acc = fma(taps[i - o + r], v[i], acc) over the
    in-volume inputs i in ascending order, from acc = 0."""
    import numpy as np

    r = len(taps) // 2
    for axis in (-1, -2, -3):
        u = np.moveaxis(v, axis, -1)
        n = u.shape[-1]
        o = np.arange(n)
        acc = np.zeros_like(u)
        for k in range(2 * r + 1):
            i = o - r + k
            src = u[..., np.clip(i, 0, n - 1)]
            acc = np.where((i >= 0) & (i < n), fma_f32(np.full_like(src, taps[k]), src, acc), acc)
        v = np.moveaxis(acc, -1, axis)
    return v


def nvcc_report(names) -> dict:
    """{kernel<template args>: [registers, shared bytes, spill store bytes,
    spill load bytes]} from the build's nvcc.log (ptxas -v) for the kernels
    whose names contain one of names."""
    from sift3d_torch.kernels import cuda_lib

    def short(mangled):
        # _ZN <len><namespace> <len><name> [I Li<n>E / Lb<n>E ... E] ...: the name and its int or
        # bool arguments
        pos, name = 3, ""
        while pos < len(mangled) and mangled[pos].isdigit():
            n = re.match(r"\d+", mangled[pos:]).group()
            pos += len(n)
            name = mangled[pos:pos + int(n)]
            pos += int(n)
        args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
        ints = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
        return name + (f"<{','.join(ints)}>" if ints else "")

    report, entry, spills = {}, None, (0, 0)
    for line in (cuda_lib.library_path().parent / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = short(m.group(1))
            entry = entry if any(n in entry for n in names) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            report[entry] = [int(m.group(1)), int(m.group(2)), *spills]
            entry = None
    return report


def sass_count(kernel: str, opcode: str) -> dict:
    """{function: instructions whose opcode starts with `opcode`} in the
    built library's SASS (cuobjdump -sass) for the functions whose mangled
    name contains `kernel`."""
    from sift3d_torch.kernels import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(cuda_lib.library_path())], capture_output=True, text=True, check=True)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?" + opcode, line):
            counts[fn] += 1
    return counts


EDGE_SIGMAS = (0.5, 0.95, 1.2, 1.6, 2.0, 2.4, 2.8, 3.0897)  # blur radii 1..8


def kernel_edges(dev, cfg, band) -> None:
    """Phase 2 edge shapes. K7 against the plain blur on the CPU (the same
    fma chain, exact): volumes thinner than 2r + 1 along z, y and x in turn,
    sizes that are no multiple of a tile, a batch of three octave-1
    volumes, and every radius 1..8 on one octave-1 volume; at the deepest
    T1 octave (5 x 6 x 5), where the CPU's plain blur sums in another
    order, against the fma chain computed in numpy. K3 (k = 6 and
    11), K8 and K9 against their plain versions on the card (exact) on
    synthetic rows with V in {1, 127, 128, 129, 485}, with an all-zero-weight
    row, and with two exactly tied peaks; K9's top-k must be K3's output."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import gauss, gauss_cuda, hist_cuda

    rng = np.random.default_rng(11)
    level5 = cfg.incremental_sigmas()[-1]
    cases = [((5, 40, 300), level5, "z thinner than 2r+1"), ((300, 7, 40), level5, "y thinner than 2r+1"),
             ((40, 300, 9), level5, "x thinner than 2r+1"), ((37, 75, 61), 1.6, "no axis a tile multiple"),
             ((3, 91, 109, 91), level5, "batch of 3 octave-1 volumes")]
    cases += [((91, 109, 91), s, f"radius {r}") for r, s in enumerate(EDGE_SIGMAS, 1)]
    for shape, sigma, what in cases:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        xd = x.to(dev)
        err = max_abs(gauss_cuda.blur3d(xd, sigma, cfg.blur_precision).cpu(),
                      gauss.blur3d(x, sigma, cfg.blur_precision))
        rate = blur_rate(xd, sigma, cfg.blur_precision)
        print(f"phase2 blur3d edge, {what} {shape}, sigma {sigma!r}: max_abs_err {err!r} against the plain "
              f"version on the CPU (exact); {rate}")
        if err != 0.0 or (what.startswith("radius") and f"r {what.split()[1]}," not in rate):
            raise AssertionError(f"K7 differs from the CPU plain blur on {what} {shape}: {err}")
    # the deepest octave of the T1 grid: K7 against the fma chain in numpy
    # (the CPU plain blur sums its y pass in another order at this shape)
    deep = rng.standard_normal((5, 6, 5)).astype(np.float32)
    for sigma in cfg.incremental_sigmas():
        taps = gauss_cuda.host_taps(float(sigma), float(cfg.blur_precision)).numpy()
        got = gauss_cuda.blur3d(torch.from_numpy(deep).to(dev), sigma, cfg.blur_precision).cpu()
        err = max_abs(got, torch.from_numpy(fma_chain_blur3d(deep, taps)))
        cpu_err = max_abs(got, gauss.blur3d(torch.from_numpy(deep), sigma, cfg.blur_precision))
        print(f"phase2 blur3d edge, deepest T1 octave (5, 6, 5), sigma {sigma!r} (r {len(taps) // 2}): "
              f"max_abs_err {err!r} against the fma chain (exact), {cpu_err!r} against the CPU plain blur")
        if err != 0.0:
            raise AssertionError(f"K7 differs from the fma chain at (5, 6, 5), sigma {sigma}: {err}")

    def rows(c, v):
        e = rng.standard_normal((c, v, 3)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        w = np.abs(rng.standard_normal((c, v))).astype(np.float32)
        return [np.ascontiguousarray(e[..., i] * 5 + 5) for i in range(3)] + [w]

    sets = [(f"V={v}", rows(8, v)) for v in (1, 127, 128, 129, 485)]
    zero = rows(8, 485)
    zero[3][2] = 0.0
    sets.append(("row 2 of zero weight, V=485", zero))
    # two single-bin points at mirrored x give two exactly equal peaks
    tie = [np.full((2, 3), 5.0, np.float32) for _ in range(3)] + [np.tile(np.float32([1.0, 1.0, 0.5]), (2, 1))]
    tie[0][0], tie[0][1] = [7.0, 3.0, 9.0], [3.0, 7.0, 1.0]
    sets.append(("two tied peaks, V=3", tie))
    for what, pts in sets:
        t = [torch.from_numpy(a).to(dev) for a in pts]
        errs = {}
        for k in (6, 11):
            errs[f"hist_topk k={k}"] = max_abs(hist_cuda.hist_topk(*t, band, k), hist_cuda.hist_topk_plain(*t, band, k))
        errs["splat_histogram_raw"] = max_abs(hist_cuda.splat_histogram_raw_bins(*t),
                                              hist_cuda.splat_histogram_raw_plain(*t))
        got, want = hist_cuda.smooth_histogram_peaks_bins(*t, band), hist_cuda.smooth_histogram_peaks_plain(*t, band)
        errs["smooth_histogram_peaks"] = max(max_abs(got[0], want[0]), max_abs(got[1], want[1]))
        top_is_k3 = all(torch.equal(hist_cuda.peak_rows(*got, k), hist_cuda.hist_topk(*t, band, k)) for k in (6, 11))
        print(f"phase2 histogram edge, {what}: max_abs_err {json.dumps(errs)} (exact); "
              f"K9's top-k equals K3 {top_is_k3}")
        if max(errs.values()) != 0.0 or not top_is_k3:
            raise AssertionError(f"a histogram kernel differs from its plain version on {what}: {errs}")
        if what.startswith("two tied"):
            out = hist_cuda.hist_topk(*t, band, 4).cpu()
            if not (out[0, 0, 0] == out[0, 1, 0] and (out[:, :2, 7] % 16).tolist() == [[3, 7], [3, 7]]):
                raise AssertionError("the tied peaks did not come lowest flat index first")


XY_Z_LAUNCHES = [dict(kind="xy_z", ry=ry, z=z) for ry in (8, 4, 2) for z in ((16, 64, 4), (16, 32, 2), (4, 32, 2))]


def blur_geometry_sweep(x, sigma, min_value, label, launches=XY_Z_LAUNCHES) -> None:
    """K7 at other launches than the chosen one on the same input: each
    output equal to the chosen launch's, with its median ms of single
    calls and a call's share of a burst."""
    import torch

    from sift3d_torch.kernels import gauss_cuda

    shape = (1, *x.shape) if x.ndim == 3 else tuple(x.shape)
    taps = gauss_cuda.host_taps(float(sigma), float(min_value))
    chosen = gauss_cuda.blur_launch_geometry(shape, taps.shape[0] // 2, gauss_cuda.sm_count(x.device))
    want = gauss_cuda.blur3d(x, sigma, min_value)
    times = {}
    for g in [chosen, *launches]:
        run = functools.partial(gauss_cuda._launch, x, taps, g)
        same = torch.equal(run(), want)
        times[json.dumps(g)] = [round(median_ms(run), 4), round(burst_ms(run), 4), same]
        if not same:
            raise AssertionError(f"K7 at {g} differs from the chosen launch")
    print(f"phase2 blur3d launches, {label} {tuple(x.shape)} r {taps.shape[0] // 2}: chosen {json.dumps(chosen)}; "
          f"[ms, back to back ms, equal to the chosen] {json.dumps(times)}")


def extrema_edges(dev) -> None:
    """Phase 2 edge inputs of K1 and K6 (csrc/dogs_extrema.cu), each exact
    against the plain version on the card at every launch that
    extrema_launch_geometry can choose: extents of 3 and 4 along z, y and
    x, a 37x75x61 volume, the deepest T1 octave (5x6x5), each a batch of
    three; every input with plateaus, ties, +-0, +-inf and NaN planted on
    the seams of the tiles and z runs (utils.synthetic.extrema_edge_stack)."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import extrema_cuda
    from sift3d_torch.utils.synthetic import extrema_edge_stack

    shapes = [(3, 40, 70), (40, 3, 70), (40, 70, 3), (4, 40, 70), (40, 4, 70), (40, 70, 4),
              (37, 75, 61), (5, 6, 5)]
    for shape in shapes:
        gs = np.stack([extrema_edge_stack(shape, 6, k * 7 + sum(shape)) for k in range(3)])
        gs = torch.from_numpy(gs).to(dev)
        dogs, mask = extrema_cuda.dogs_extrema_plain(gs)
        batch = np.stack([extrema_edge_stack(shape, 5, k + sum(shape)) for k in range(3)])
        batch = torch.from_numpy(batch).to(dev)
        mask6 = extrema_cuda.extrema_mask_plain(batch)
        errs = {}
        for ty, zr in extrema_cuda.LAUNCHES:
            g = dict(ty=ty, zr=zr)
            got_dogs, got_mask = extrema_cuda._launch_dogs(gs, g)
            errs[f"K1 {ty}/{zr}"] = max(max_abs(got_dogs, dogs), max_abs(got_mask.float(), mask.float()))
            errs[f"K6 {ty}/{zr}"] = max_abs(extrema_cuda._launch_mask(batch, g).float(), mask6.float())
        chosen = {k: extrema_cuda.extrema_launch_geometry((3, *shape), k) for k in ("dogs_extrema", "extrema_mask")}
        special = {"nan": int(torch.isnan(gs).sum()), "inf": int(torch.isinf(gs).sum()),
                   "-0": int(((gs == 0) & torch.signbit(gs)).sum())}
        print(f"phase2 extrema edge {shape} (batches of 3), planted {json.dumps(special)}, "
              f"{int((mask != 0).sum())} K1 extrema; chosen {json.dumps(chosen)}; max_abs_err at every "
              f"launch (exact): {max(errs.values())!r} over {len(errs)}")
        if max(errs.values()) != 0.0:
            raise AssertionError(f"K1/K6 differ from their plain versions on {shape}: {errs}")


def fused_edges(dev, cfg) -> None:
    """Phase 2 edge rows of the fused K2 and K4, each exact against its
    plain version on the card. A 48 x 40 x 160 stack holds four regions
    along x, each 40 wide so a patch stays in one: zeros (constant patches:
    norm 0, a zero tensor, p2 = 0), a ramp along x (a diagonal tensor with a
    double eigenvalue, r at +-1), a bowl (nearly isotropic) and the ramp
    with a faint y slope (a nearly degenerate pair). K2's rows sit at each
    region's centre on DoG levels 1..3 with seeded sub-voxel offsets, from
    the whole stack and from a Z slab (gz0 8, dz0 10). K4's rows add
    scales above 8.80, centres outside [0, X) in x and a slab (z0 8); goh
    takes zero, constant, mirrored (tied bins) and noise patches. Prints
    how many rows hit each case, read from the plain outputs."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import descriptor, patch_cuda
    from sift3d_torch.kernels.patch import normalize_patches
    from sift3d_torch.pipeline import features

    rng = np.random.default_rng(21)
    zd, yd, xd = 48, 40, 160
    zz, yy, xx = np.mgrid[0:zd, 0:yd, 0:xd].astype(np.float32)
    vol = np.zeros((zd, yd, xd), np.float32)
    vol[..., 40:80] = 0.5 * xx[..., 40:80]
    vol[..., 80:120] = 0.01 * ((zz - 24) ** 2 + (yy - 20) ** 2 + (xx - 100) ** 2)[..., 80:120]
    vol[..., 120:] = 0.5 * xx[..., 120:] + 1e-3 * yy[..., 120:]
    gstack = torch.from_numpy(np.stack([vol * (1.0 + 0.01 * k) for k in range(6)])).to(dev)
    dogs = np.full((5, zd, yd, xd), 0.5, np.float32)
    cands = []
    for cx in (20, 60, 100, 140):
        for lv in (1, 2, 3):
            for dz, dy, dx in ((0, 0, 0), (-3, 3, 3), (3, -3, -3)):
                z, y, x = 24 + dz + 4 * (lv - 2), 20 + dy, cx + dx
                cands.append((lv, z, y, x))
                for axis in range(4):
                    for step in (-1, 1):
                        at = [lv, z, y, x]
                        at[axis] += step
                        dogs[tuple(at)] = rng.uniform(0.3, 0.7)
                dogs[lv, z, y, x] = 1.0
    dogs = torch.from_numpy(dogs).to(dev)
    lvl = torch.tensor([c[0] for c in cands], device=dev)
    zyx = torch.tensor([c[1:] for c in cands], device=dev)
    sig = tuple(cfg.level_sigmas())
    cases = {"whole stack": (gstack, dogs, {}),
             "Z slab, gz0 8, dz0 10": (gstack[:, 8:44].contiguous(), dogs[:, 10:40].contiguous(),
                                       dict(gz0=8, dz0=10, depth=zd))}
    for what, (g, d, kw) in cases.items():
        got = features.gather_eig(g, d, lvl, zyx, sig, cfg, **kw)
        want = features.gather_eig_plain(g, d, lvl, zyx, sig, cfg, **kw)
        err = max(max_abs(a.float(), b.float()) for a, b in zip(got, want))
        _, _, inb, pn, eigs, _, keep = want
        e = eigs.abs().max(dim=1).values.clamp_min(1e-30)
        gaps = torch.stack([(eigs[:, 0] - eigs[:, 1]).abs(), (eigs[:, 1] - eigs[:, 2]).abs()], 1) / e[:, None]
        hits = {"norm 0": int((pn.reshape(len(cands), -1) == 0).all(1).sum()),
                "three equal eigenvalues": int((gaps == 0).all(1).sum()),
                "a double eigenvalue (r at +-1)": int(((gaps == 0).any(1) & (gaps != 0).any(1)).sum()),
                "a nearly degenerate pair (gap < 1e-3 of the largest)":
                    int(((gaps < 1e-3) & (gaps > 0)).any(1).sum()),
                "in bounds": int(inb.sum()), "kept": int(keep.sum())}
        print(f"phase2 gather_eig edge rows, {what}: {len(cands)} rows {json.dumps(hits)}; "
              f"max_abs_err {err!r} (exact)")
        if err != 0.0:
            raise AssertionError(f"the fused K2 differs from its plain version on the edge rows, {what}")

    n = 48
    lv = torch.from_numpy(rng.integers(1, 4, n).astype(np.int32)).to(dev)
    centers = np.stack([rng.choice([20.0, 60.0, 100.0, 140.0], n) + rng.uniform(-3, 3, n),
                        rng.uniform(12, 28, n), rng.uniform(18, 30, n)], 1).astype(np.float32)
    centers[:6, 0] = [-2.0, 0.5, 3.0, xd - 3.0, xd - 0.5, xd + 2.0]  # outside in x
    scales = rng.uniform(1.0, 4.0, n).astype(np.float32)
    scales[6:16] = rng.uniform(8.9, 14.0, 10)  # above the 64^3 box's 8.80
    oris = np.stack([rotation(k) for k in range(n)]).astype(np.float32)
    rows = [lv, torch.from_numpy(centers).to(dev), torch.from_numpy(scales).to(dev), torch.from_numpy(oris).to(dev)]
    small = [t[16:] for t in rows]  # small rows in the slab's middle: every read inside it
    slab = gstack[:, 8:44].contiguous()
    errs = {"whole stack": max_abs(patch_cuda.rotated_goh(gstack, *rows).float(),
                                   patch_cuda.rotated_goh_plain(gstack, *rows).float()),
            "Z slab, z0 8": max_abs(patch_cuda.rotated_goh(slab, *small, 8, zd).float(),
                                    patch_cuda.rotated_goh_plain(slab, *small, 8, zd).float())}
    patches = torch.from_numpy(rng.standard_normal((8, 11, 11, 11)).astype(np.float32)).to(dev)
    patches[0] = 0.0
    patches[1] = 3.0
    patches[2] = (torch.arange(11, device=dev) - 5.0).abs()  # mirrored in x: tied bins
    patches[3] = (torch.arange(11, device=dev)[:, None, None] - 5.0).abs() * 2.0
    errs["goh"] = max_abs(patch_cuda.goh(patches).float(), patch_cuda.goh_plain(patches).float())
    vals = descriptor.normalize_positive(descriptor.goh_descriptor(normalize_patches(
        torch.cat([patch_cuda.sample_rotated_plain(gstack, *rows), patches]))))
    tied = int(sum(int(torch.unique(v).numel() < 64) for v in vals))
    flat = int((vals == 0).all(1).sum())
    print(f"phase2 rotated_goh / goh edge rows: {n} rotated rows (6 reaching outside x, 10 at scales "
          f"{float(scales[6:16].min())!r}..{float(scales[6:16].max())!r}), {n - 16} from a slab, "
          f"{patches.shape[0]} given patches; {tied} rows with tied bins, {flat} all tied; "
          f"max_abs_err {json.dumps(errs)} (exact)")
    if max(errs.values()) != 0.0:
        raise AssertionError(f"the fused K4 differs from its plain version on the edge rows: {errs}")

    # the fused BRIEF kernels on the same rows and patches (and a NaN patch),
    # every variant and pair table; rows on a level out of range (a NaN
    # patch) against K4's patch mode and the plain chain
    patches[4] = float("nan")
    nan_rows = [lv.clone(), *rows[1:]]
    nan_rows[0][::5] = gstack.shape[0]
    brief_errs = {}
    for v in ("brief", "rrief", "nrrief"):
        for m in range(5):
            cases = {
                "whole stack": (patch_cuda.rotated_brief(gstack, *rows, 0, None, v, m),
                                patch_cuda.rotated_brief_plain(gstack, *rows, 0, None, v, m)),
                "Z slab, z0 8": (patch_cuda.rotated_brief(slab, *small, 8, zd, v, m),
                                 patch_cuda.rotated_brief_plain(slab, *small, 8, zd, v, m)),
                "given patches": (patch_cuda.brief(patches, v, m), patch_cuda.brief_plain(patches, v, m)),
                "levels out of range": (patch_cuda.rotated_brief(gstack, *nan_rows, 0, None, v, m),
                                        patch_cuda.brief_plain(patch_cuda.sample_rotated(gstack, *nan_rows), v, m)),
            }
            for what, (got, want) in cases.items():
                brief_errs[what] = max(brief_errs.get(what, 0.0), max_abs(got.float(), want.float()))
    print(f"phase2 rotated_brief / brief edge rows: the rotated rows above, every 5th also on a level out "
          f"of range, the slab rows, the given patches and a NaN patch; BRIEF, RRIEF, NRRIEF, pair tables 0-4; "
          f"max_abs_err {json.dumps(brief_errs)} (exact)")
    if max(brief_errs.values()) != 0.0:
        raise AssertionError(f"the fused BRIEF kernels differ from their plain versions on the edge rows: {brief_errs}")


def extrema_geometry_sweep(x, label, kernel) -> None:
    """K1 (kernel "dogs_extrema", x a Gaussian stack) or K6 ("extrema_mask",
    x DoGs) at every launch extrema_launch_geometry can choose on the same
    input: each output equal to the plain version's, with its median ms of
    single calls and a call's share of a burst."""
    import torch

    from sift3d_torch.kernels import extrema_cuda
    from sift3d_torch.kernels.gauss_cuda import sm_count

    batch = x if x.ndim == 5 else x[None]
    shape = (batch.shape[0], *batch.shape[2:])
    if kernel == "dogs_extrema":
        want = extrema_cuda.dogs_extrema_plain(batch)
        run = functools.partial(extrema_cuda._launch_dogs, batch)
    else:
        want = (extrema_cuda.extrema_mask_plain(batch),)
        run = functools.partial(extrema_cuda._launch_mask, batch)
    chosen = extrema_cuda.extrema_launch_geometry(shape, kernel, sm_count(x.device))
    times = {}
    for ty, zr in extrema_cuda.LAUNCHES:
        g = dict(ty=ty, zr=zr)
        got = run(g)
        got = got if isinstance(got, tuple) else (got,)
        same = all(max_abs(a.float(), b.float()) == 0.0 for a, b in zip(got, want))
        call = functools.partial(run, g)
        times[f"{ty}/{zr}"] = [round(median_ms(call), 4), round(burst_ms(call), 4), same]
        if not same:
            raise AssertionError(f"{kernel} at {g} differs from its plain version on the {label} input")
    print(f"phase2 {kernel} launches (ty/zr), {label} {tuple(x.shape)}: chosen {json.dumps(chosen)}; "
          f"[ms, back to back ms, equal to the plain version] {json.dumps(times)}")


def device_profile(fn):
    """Run fn() once under torch.profiler; returns (device busy ms, span ms
    from the first device event's start to the last one's end, device
    events, runtime launch calls, {kernel name: [events, device ms]} in
    descending ms, {stage: [launch calls, stage calls]}, {stage: device
    ms}), or None when the trace holds no device event. Stages are the
    profiler ranges "stage:<name>" that the port's tracer
    (``utils.timing``) opens under the profiler; a launch counts in every
    stage whose range holds it, and a device event in every stage whose
    range on the device (the trace's annotation of that range) holds its
    start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # a stage range also shows on the device as an annotation spanning its
    # kernels: not device work
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("stage:")]
    if not dev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    launch_names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
    per_name = {}
    for e in dev:
        n_ms = per_name.setdefault(e.name[:100], [0, 0.0])
        n_ms[0] += 1
        n_ms[1] += e.time_range.elapsed_us() / 1e3
    per_name = dict(sorted(per_name.items(), key=lambda kv: -kv[1][1]))
    launches = [e.time_range.start for e in events if e.name in launch_names]
    spans = {}
    for e in events:
        if e.name.startswith("stage:") and e.device_type == torch.autograd.DeviceType.CPU:
            spans.setdefault(e.name[len("stage:"):], []).append((e.time_range.start, e.time_range.end))
    per_stage = {name: [sum(1 for t in launches if any(a <= t <= b for a, b in ranges)), len(ranges)]
                 for name, ranges in spans.items()}
    marks = {}
    for e in events:
        if e.name.startswith("stage:") and e.device_type == torch.autograd.DeviceType.CUDA:
            marks.setdefault(e.name[len("stage:"):], []).append((e.time_range.start, e.time_range.end))
    stage_ms = {name: sum(e.time_range.elapsed_us() for e in dev if any(a <= e.time_range.start <= b
                                                                          for a, b in ranges)) / 1e3
                for name, ranges in marks.items()}
    return busy, span, len(dev), len(launches), per_name, per_stage, stage_ms


def kernel_device_ms(fn, tag: str, calls: int = 10):
    """[events, device ms an event] of the kernels whose name holds tag over
    `calls` calls of fn under torch.profiler (the trace may miss some; None:
    it holds no device event): a kernel's own time, without its wrapper's
    host work."""
    def run():
        for _ in range(calls):
            fn()

    prof = device_profile(run)
    if prof is None:
        return None
    hits = [v for name, v in prof[4].items() if tag in name]
    events = sum(n for n, _ in hits)
    return [events, sum(ms for _, ms in hits) / max(events, 1)]


def record_kernel(results, name, source, replaces, kernel, plain, tol, note, n_bytes, flops, library=None,
                  chain=None, plain_reps=REPS, int8_ops=0.0):
    """Phase 2's check of one kernel: kernel() against plain() (each a
    tensor or a tuple of them) within tol, their median ms, the bound, the
    library call's ms and back-to-back times; appends the kernel table's
    row to results and raises on a disagreement."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs(g.float(), w.float()) for g, w in zip(got, want))
    ms, plain_ms = median_ms(kernel), median_ms(plain, plain_reps)
    bound_ms, bound_by = bound(n_bytes, flops, int8_ops)
    library_ms = None if library is None else median_ms(library)
    burst = [burst_ms(kernel), None if library is None or library_ms > 5 else burst_ms(library)]
    replaced = "" if chain is None else f"; the eager chain it replaces {json.dumps(chain_time(chain))}"
    print(
        f"phase2 {name}: {note}; max_abs_err {err!r} (tolerance {tol!r}); "
        f"kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
        f"({n_bytes!r} B, {flops!r} FLOP{f', {int8_ops!r} int8 operations' if int8_ops else ''}), "
        f"library {library_ms!r} ms; back to back [kernel, "
        f"library] {burst!r} ms a call{replaced}"
    )
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version at {note}: {err} > {tol}")
    results.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))


def table_rows(results) -> list:
    """The kernel table's rows of a phase's results: each kernel's first
    row (its times at the first shape it was checked at) with its largest
    error over all."""
    table = {}
    for r in results:
        first = table.setdefault(r["name"], r)
        first["max_abs_err"] = max(first["max_abs_err"], r["max_abs_err"])
    return list(table.values())


def compare_kernels(vol, cfg):
    """Phase 2: every kernel against its plain version at main-path shapes.
    Returns the kernel table's rows: each kernel's times at the T1 shapes
    (the first shape it is checked at) and its largest error over all."""
    import numpy as np
    import torch

    from sift3d_torch.core.config import initial_blur_sigma
    from sift3d_torch.kernels import extrema_cuda, gauss, gauss_cuda, hist_cuda, patch_cuda, resample_cuda
    from sift3d_torch.kernels.resample import double_size, isotropic_resample, isotropic_shape, subsample_2x
    from sift3d_torch.pipeline import features, pyramid

    results = []
    record = functools.partial(record_kernel, results)

    # K10 on a -2+ sub-batch of T1 volumes (the planner's 16 on one card),
    # against the plain chain volume by volume, exactly; its bound: each
    # input voxel read once (4 B) and its 8 outputs written once (32 B)
    gen = torch.Generator(device=vol.device).manual_seed(19)
    batch = 400.0 * torch.rand((16,) + tuple(vol.shape), generator=gen, device=vol.device) - 150.0
    out = torch.empty((16,) + resample_cuda.doubled_shape(vol.shape), device=vol.device)
    record(
        "double_size_batch", "sift3d_torch/csrc/double_size.cu", "sift3d/kernels/resample.py:67",
        lambda: resample_cuda.double_size_batch(batch, out),
        lambda: torch.stack([double_size(v) for v in batch]),
        0.0, f"-2+ sub-batch {tuple(batch.shape)} -> {tuple(out.shape)} (exact)",
        36 * batch.numel(), 28 * batch.numel(), plain_reps=3,
    )
    bits = bool(all(torch.equal(resample_cuda.double_size_batch(batch, out)[b], double_size(batch[b]))
                    for b in range(batch.shape[0])))
    print(f"phase2 double_size_batch: bit-equal to the plain chain on every volume {bits}")
    if not bits:
        raise AssertionError("K10 differs from the plain double_size chain")
    del batch, out
    torch.cuda.empty_cache()

    # K11 on a -w sub-batch of OASIS-1 scans (the planner's 32 on one card),
    # against the plain chain volume by volume, bit for bit; its bound: each
    # input voxel read once and each output voxel written once (4 B each)
    def chain(b, mm):
        return torch.stack([isotropic_resample(v, mm)[0] for v in b])

    def bits_equal(a, b):
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b))
                    and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    gen = torch.Generator(device=vol.device).manual_seed(25)
    batch = 100.0 * torch.randn((32,) + OASIS_DIMS, generator=gen, device=vol.device)
    out = torch.empty((32,) + isotropic_shape(OASIS_DIMS, OASIS_MM), device=vol.device)
    record(
        "isotropic_resample_batch", "sift3d_torch/csrc/isotropic_resample.cu", "sift3d/kernels/resample.py:166",
        lambda: resample_cuda.isotropic_resample_batch(batch, out, OASIS_MM),
        lambda: chain(batch, OASIS_MM),
        0.0, f"-w sub-batch {tuple(batch.shape)} at {OASIS_MM} mm -> {tuple(out.shape)} (exact)",
        4 * (batch.numel() + out.numel()), 28 * out.numel(), plain_reps=3,
    )
    bits = {"oasis": bits_equal(resample_cuda.isotropic_resample_batch(batch, out, OASIS_MM),
                                chain(batch, OASIS_MM))}
    del batch, out
    torch.cuda.empty_cache()
    rng = np.random.default_rng(25)
    edges = [((1, 5, 7, 9), (1.0, 1.0, 1.25)), ((2, 6, 8, 10), (1.2, 0.9375, 1.0)),
             ((1, 1, 7, 9), (1.0, 1.0, 1.5)), ((1, 5, 1, 9), (1.0, 3.0, 1.0)), ((1, 5, 7, 1), (3.0, 1.0, 1.0)),
             ((1, 1, 1, 1), (1.0, 1.0, 1.25)), ((3, 37, 75, 61), (0.9375, 0.9375, 1.2)),
             ((2, 91, 109, 91), (1.5, 1.0, 1.0))]
    for shape, mm in edges:
        x = (100 * rng.standard_normal(shape)).astype(np.float32)
        x.flat[rng.choice(x.size, min(x.size, 10), replace=False)] = [np.nan, np.inf, -np.inf, -0.0, 0.0] * 2
        x = torch.from_numpy(x).to(vol.device)
        got = torch.full((shape[0],) + isotropic_shape(shape[1:], mm), float("nan"), device=vol.device)
        resample_cuda.isotropic_resample_batch(x, got, mm)
        bits[f"{shape} {mm}"] = bits_equal(got, chain(x, mm)) and bits_equal(got.cpu(), chain(x.cpu(), mm))
    print(f"phase2 isotropic_resample_batch: bit-equal to the plain chain (on the card and, at the edge "
          f"shapes, on the CPU) {json.dumps(bits)}")
    if not all(bits.values()):
        raise AssertionError(f"K11 differs from the plain isotropic_resample chain: {bits}")

    # K7 at the blur shapes of the paths: against cuBLAS (the plain version
    # on the card, another summation order) within 1e-6 of the peak, and
    # against the plain version on the CPU (the same fma chain) exactly
    patches = torch.from_numpy(
        np.random.default_rng(0).standard_normal((MIN_ROWS, 11, 11, 11)).astype(np.float32)
    ).to(vol.device)
    doubled = double_size(vol)
    level5 = cfg.incremental_sigmas()[-1]
    blur_cases = [
        ("initial blur", vol, initial_blur_sigma(cfg), True),
        ("level-5 blur", vol, level5, True),
        ("-2+ initial blur", doubled, initial_blur_sigma(cfg, 0.5), False),
        ("-2+ level-5 blur", doubled, level5, False),
        ("BRIEF pre-blur", patches, cfg.brief_blur_sigma, True),
    ]
    for note, x, sigma, on_cpu in blur_cases:
        peak = float(x.abs().max())
        print(f"phase2 blur3d: {note} {tuple(x.shape)}: {blur_rate(x, sigma, cfg.blur_precision)}")
        taps = gauss_cuda.device_taps(float(sigma), float(cfg.blur_precision), x.device).shape[0]
        record(
            "blur3d", "sift3d_torch/csrc/blur3d.cu", "sift3d/kernels/gauss_pallas.py:97",
            lambda: gauss_cuda.blur3d(x, sigma, cfg.blur_precision),
            lambda: gauss.blur3d(x, sigma, cfg.blur_precision),
            1e-6 * peak, f"{note} {tuple(x.shape)}, sigma {sigma!r}",
            8 * x.numel(), 2 * 3 * taps * x.numel(), conv3d_call(x, sigma, cfg.blur_precision),
        )
        if on_cpu:
            got = gauss_cuda.blur3d(x, sigma, cfg.blur_precision).cpu()
            cpu_err = max_abs(got, gauss.blur3d(x.cpu(), sigma, cfg.blur_precision))
            print(f"phase2 blur3d: {note} against the plain version on the CPU: max_abs_err {cpu_err!r} (exact)")
            if cpu_err != 0.0:
                raise AssertionError(f"K7 differs from the CPU plain blur at the {note}: {cpu_err}")
    # the BRIEF batch through xy + z, against the small-volume kernel
    blur_geometry_sweep(patches, cfg.brief_blur_sigma, cfg.blur_precision, "BRIEF pre-blur",
                        [dict(kind="xy_z", ry=ry, z=z) for ry in (1, 2) for z in ((16, 32, 1), (16, 256, 1))])
    del patches
    blur_geometry_sweep(vol, initial_blur_sigma(cfg), cfg.blur_precision, "T1 initial blur")
    blur_geometry_sweep(vol, level5, cfg.blur_precision, "T1 level-5 blur")
    blur_geometry_sweep(doubled, level5, cfg.blur_precision, "-2+ level-5 blur")
    kernel_edges(vol.device, cfg, features.ori_hist_band(cfg, vol.device))
    extrema_edges(vol.device)
    fused_edges(vol.device, cfg)

    # K1-K4 on the octave-0 Gaussian stack of each resampling path and on
    # its rows: the T1 grid (rows tiled to a realistic count; these times
    # go into the table), the -2+ grid (a 1.39 GB stack) and the -2- grid
    for label, img, scale, tile in (
        ("T1", vol, 1.0, MIN_ROWS),
        ("-2+", doubled, 0.5, 0),
        ("-2-", subsample_2x(vol), 1.0, 0),
    ):
        gstack, _, _, _ = pyramid.octave_core(pyramid.initial_blur_core(img, cfg, scale), cfg)
        gstack = gstack.contiguous()
        vox = gstack[0].numel()
        record(
            "dogs_extrema", "sift3d_torch/csrc/dogs_extrema.cu", "sift3d/kernels/extrema_pallas.py:284",
            lambda: extrema_cuda.dogs_extrema(gstack), lambda: extrema_cuda.dogs_extrema_plain(gstack),
            0.0, f"{label} octave-0 gstack {tuple(gstack.shape)} (exact)", 47 * vox, 5 * vox,
        )
        if label != "-2-":
            extrema_geometry_sweep(gstack, f"{label} octave-0 gstack", "dogs_extrema")
        dogs, mask = extrema_cuda.dogs_extrema(gstack)
        # K6 on the octave's DoGs (T1), and on shard 1 of a 4-shard -2+
        # octave 0 with its one-plane halo (the Z-sharded path's input)
        if label != "-2-":
            if label == "-2+":
                tz = -(-dogs.shape[1] // 8) * 8 // 4
                d6 = dogs[:, tz - 1 : 2 * tz + 1].contiguous()
                note6 = f"-2+ shard 1 of 4, DoG slab {tuple(d6.shape)} (exact)"
            else:
                d6, note6 = dogs, f"T1 octave-0 DoGs {tuple(dogs.shape)} (exact)"
            record(
                "extrema_mask", "sift3d_torch/csrc/dogs_extrema.cu", "sift3d/kernels/extrema_pallas.py:330",
                lambda: extrema_cuda.extrema_mask(d6), lambda: extrema_cuda.extrema_mask_plain(d6),
                0.0, note6, 23 * d6[0].numel(), 0,
            )
            extrema_geometry_sweep(d6, note6.split(" (")[0], "extrema_mask")
            del d6

        lvl, zyx, _ = features.candidate_table(mask)
        sig = tuple(cfg.level_sigmas())
        xyz, scale_, in_bounds, pn, _, _, eig_keep = features.gather_eig(gstack, dogs, lvl, zyx, sig, cfg)
        lvl32 = lvl.to(torch.int32)
        # the fused K2 on the octave's candidates: refinement, patch, eigen
        # test; its yardstick is the eager chain of its plain pieces
        rows = at_least([lvl32, xyz, scale_], tile)
        crows = at_least([lvl, zyx.contiguous()], tile)
        n_rows = rows[0].shape[0]
        touched = touched_voxels(gstack.shape, rows[0], *patch_points(*rows))
        record(
            "gather_eig", "sift3d_torch/csrc/identity_eig.cu", "sift3d/kernels/patch.py:375",
            lambda: features.gather_eig(gstack, dogs, *crows, sig, cfg),
            lambda: features.gather_eig_plain(gstack, dogs, *crows, sig, cfg),
            0.0, f"{label}: {lvl.shape[0]} octave-0 candidates as {n_rows} rows (exact)",
            GATHER_EIG_ROW_BYTES * n_rows + 4 * touched_dogs(dogs.shape, *crows) + 4 * touched,
            GATHER_EIG_ROW_FLOPS * n_rows,
            chain=lambda: features.gather_eig_plain(gstack, dogs, *crows, sig, cfg),
        )
        kidx = torch.nonzero(in_bounds & eig_keep)[:, 0]
        e3, wgt = features.sphere_edges(pn[kidx])
        band = features.ori_hist_band(cfg, vol.device)
        hx, hy, hz = features.splat_coords(e3)
        hrows = at_least([hx, hy, hz, wgt], tile)
        k1 = cfg.max_primary_orientations
        c_rows, v_pts = hrows[0].shape
        # nonzero blurred factors per axis and point: the 2 splat bins
        # widened by the band's radius on each side
        nz = 2 + 2 * (int((band[0] != 0).sum()) - 1)
        hist_note = f"{label}: {kidx.shape[0]} octave-0 primary histograms as {c_rows} rows, V={v_pts}"
        record(
            "hist_topk", "sift3d_torch/csrc/hist_topk.cu", "sift3d/kernels/hist_pallas.py:368",
            lambda: hist_cuda.hist_topk(*hrows, band, k1),
            lambda: hist_cuda.hist_topk_plain(*hrows, band, k1),
            0.0, f"{hist_note}, k={k1} (exact)",
            16 * c_rows * v_pts + 4 * 121 + 64 * k1 * c_rows, 2 * nz**3 * c_rows * v_pts,
        )
        if label == "T1":
            # K8 and K9 on the same rows; K9's top-k must be K3's output
            record(
                "splat_histogram_raw", "sift3d_torch/csrc/hist_topk.cu",
                "sift3d/kernels/hist_pallas.py:164",
                lambda: hist_cuda.splat_histogram_raw_bins(*hrows),
                lambda: hist_cuda.splat_histogram_raw_plain(*hrows),
                0.0, f"{hist_note} (raw splat, exact)",
                16 * c_rows * v_pts + 4 * 1331 * c_rows, 16 * c_rows * v_pts,
                splat_index_add_call(*hrows),
            )
            record(
                "smooth_histogram_peaks", "sift3d_torch/csrc/hist_topk.cu",
                "sift3d/kernels/hist_pallas.py:396",
                lambda: hist_cuda.smooth_histogram_peaks_bins(*hrows, band),
                lambda: hist_cuda.smooth_histogram_peaks_plain(*hrows, band),
                0.0, f"{hist_note} (histogram and peak plane, exact)",
                16 * c_rows * v_pts + 4 * 121 + 8 * 1331 * c_rows, 2 * nz**3 * c_rows * v_pts,
            )
            top = hist_cuda.peak_rows(*hist_cuda.smooth_histogram_peaks_bins(*hrows, band), k1)
            k3 = hist_cuda.hist_topk(*hrows, band, k1)
            same = bool(torch.equal(top, k3))
            print(f"phase2 smooth_histogram_peaks: top-{k1} of K9's peak plane equals K3 bit for bit: {same}")
            if not same:
                raise AssertionError("the top-k of K9's peak plane differs from K3's output")

        # the fused canonical stage on the same rows, against the plain
        # stage around K3 (its eager chain) on the card, bit for bit; its
        # bound: each patch read once and the frames written once, and the
        # histograms' multiply-adds, one a row and one a live primary
        crow = at_least([pn[kidx].contiguous()], tile)[0]
        k2 = cfg.max_secondary_orientations

        def canonical(fn):
            o = fn(crow, cfg)
            return o["ori"], o["ori_valid"]

        fused, eager = canonical(features.canonical_stage), canonical(features.canonical_stage_plain)
        live = int((eager[0][:, :, 0, 0, :] != 0).any(-1).sum())
        record(
            "canonical", "sift3d_torch/csrc/hist_topk.cu", "sift3d/pipeline/features.py:526",
            lambda: canonical(features.canonical_stage), lambda: canonical(features.canonical_stage_plain),
            0.0, f"{label}: {kidx.shape[0]} octave-0 rows as {crow.shape[0]} rows, {live} live primaries, "
            f"k1={k1}, k2={k2} (exact)",
            (4 * 1331 + 37 * k1 * k2) * crow.shape[0], 2 * nz**3 * v_pts * (crow.shape[0] + live),
            chain=lambda: canonical(features.canonical_stage_plain), plain_reps=3,
        )
        bits = (torch.equal(fused[0].view(torch.int32), eager[0].view(torch.int32))
                and torch.equal(fused[1], eager[1]))
        print(f"phase2 canonical: {label}: ori and ori_valid bit-equal to the plain stage on the card {bits}")
        if not bits:
            raise AssertionError(f"the fused canonical stage differs from the plain stage on {label}")
        del crow, fused, eager
        o = features.canonical_stage(pn[kidx], cfg)
        row, slot = features.reoriented_slots(o["ori_valid"], cfg)
        s = cfg.max_primary_orientations * cfg.max_secondary_orientations
        ori_r = o["ori"].reshape(-1, s, 3, 3)[row, slot]
        rrows = at_least(
            [lvl32[kidx][row], xyz[kidx][row], scale_[kidx][row], ori_r], tile
        )
        n_rows = rrows[0].shape[0]
        peak = float(gstack.abs().max())
        touched = touched_voxels(gstack.shape, rrows[0], *patch_points(*rrows))
        rot_note = f"{label}: {row.shape[0]} octave-0 reoriented rows as {n_rows} rows"
        record(
            "sample_rotated", "sift3d_torch/csrc/sample_rotated.cu", "sift3d/kernels/patch.py:889",
            lambda: patch_cuda.sample_rotated(gstack, *rrows),
            lambda: patch_cuda.sample_rotated_plain(gstack, *rrows),
            1e-5 * peak, rot_note, 56 * n_rows + 4 * 1331 * n_rows + 4 * touched,
            42 * 1331 * n_rows, grid_sample_call(gstack, *rrows),
        )
        # the fused K4: the rotated patches' descriptors, and the unoriented
        # rows' descriptors from their normalized patches
        record(
            "rotated_goh", "sift3d_torch/csrc/rotated_goh.cu", "sift3d/kernels/patch.py:889",
            lambda: patch_cuda.rotated_goh(gstack, *rrows),
            lambda: patch_cuda.rotated_goh_plain(gstack, *rrows),
            0.0, f"{rot_note} (exact)", 56 * n_rows + 4 * touched + 64 * n_rows,
            (42 * 1331 + GOH_ROW_FLOPS) * n_rows,
            chain=lambda: patch_cuda.goh_plain(patch_cuda.sample_rotated(gstack, *rrows)),
        )
        prows = at_least([pn[kidx].contiguous()], tile)[0]
        record(
            "goh", "sift3d_torch/csrc/rotated_goh.cu", "sift3d/pipeline/features.py:991",
            lambda: patch_cuda.goh(prows), lambda: patch_cuda.goh_plain(prows),
            0.0, f"{label}: {kidx.shape[0]} octave-0 unoriented rows as {prows.shape[0]} rows (exact)",
            (4 * 1331 + 64) * prows.shape[0], GOH_ROW_FLOPS * prows.shape[0],
            chain=lambda: patch_cuda.goh_plain(prows),
        )
        if label == "T1":
            # the fused BRIEF kernels on the same rows, each variant; their
            # yardstick is the chain they replace: K4's patch mode (rotated
            # rows) and the eager BRIEF descriptor
            m, sig = cfg.brief_method, cfg.brief_blur_sigma
            for v in ("brief", "rrief", "nrrief"):
                ops = brief_row_flops(m, sig, v)
                record(
                    "rotated_brief", "sift3d_torch/csrc/rotated_brief.cu", "sift3d/kernels/patch.py:889",
                    lambda: patch_cuda.rotated_brief(gstack, *rrows, 0, None, v, m, sig),
                    lambda: patch_cuda.rotated_brief_plain(gstack, *rrows, 0, None, v, m, sig),
                    0.0, f"{rot_note}, {v}, pair table {m} (exact)", 56 * n_rows + 4 * touched + 64 * n_rows,
                    (42 * 1331 + ops) * n_rows,
                    chain=lambda: patch_cuda.brief_plain(patch_cuda.sample_rotated(gstack, *rrows), v, m, sig),
                )
                record(
                    "brief", "sift3d_torch/csrc/rotated_brief.cu", "sift3d/pipeline/features.py:991",
                    lambda: patch_cuda.brief(prows, v, m, sig), lambda: patch_cuda.brief_plain(prows, v, m, sig),
                    0.0, f"{label}: {kidx.shape[0]} octave-0 unoriented rows as {prows.shape[0]} rows, {v} (exact)",
                    (4 * 1331 + 64) * prows.shape[0], ops * prows.shape[0],
                    chain=lambda: patch_cuda.brief_plain(prows, v, m, sig),
                )
        del gstack, dogs, mask, pn

    return table_rows(results)


def rotation(seed: int):
    """A proper 3x3 rotation from a seed."""
    import numpy as np

    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def write_aniso(path: str, data, seed: int) -> None:
    """data at 1x1x2 mm voxels with a rotated, offset qform and sform."""
    import numpy as np

    from sift3d_torch.io import nifti

    def affine(s, offset):
        m = np.eye(4)
        m[:3, :3] = rotation(s) * np.array([1.0, 1.0, 2.0])
        m[:3, 3] = offset
        return m

    nifti.write(path, np.ascontiguousarray(data), voxel_size=(1.0, 1.0, 2.0),
                qto_xyz=affine(seed, [-31.5, 20.25, -12.0]), sto_xyz=affine(seed + 1, [10.0, -20.0, 30.0]))


# the C entries (cuda_lib.SIGNATURES) whose launches each label of the
# launch counts and of the kernel table counts (cuda_lib keeps them): M1's
# int8 route is its main kernel and the slices' merge, beside the pre-pass
# it shares with M2's int8 route (knn_prep_i8), and M3's scores and inlier
# masks are the two modes of one entry (hough)
ENTRIES = {
    "blur3d": ("sift3d_blur3d",), "dogs_extrema": ("sift3d_dogs_extrema",),
    "extrema_mask": ("sift3d_extrema_mask",), "gather_eig": ("sift3d_identity_eig",),
    "canonical": ("sift3d_canonical",), "rotated_goh": ("sift3d_rotated_goh",), "goh": ("sift3d_goh",),
    "rotated_brief": ("sift3d_rotated_brief",), "brief": ("sift3d_brief",),
    "sample_rotated": ("sift3d_sample_rotated",), "double_size_batch": ("sift3d_double_size",),
    "isotropic_resample_batch": ("sift3d_isotropic_resample",),
    "hist_topk": ("sift3d_hist_topk",), "splat_histogram_raw": ("sift3d_splat_histogram_raw",),
    "smooth_histogram_peaks": ("sift3d_smooth_histogram_peaks",),
    "knn_prep_i8": ("sift3d_knn_prep_i8",), "knn_topk_int8": ("sift3d_knn_topk_i8", "sift3d_knn_merge"),
    "knn_topk_f32": ("sift3d_knn_topk",), "ratio_match_int8": ("sift3d_ratio_match_i8",),
    "ratio_match_f32": ("sift3d_ratio_match",), "hough": ("sift3d_hough",),
}
# the main path's kernels, and the matching kernels of featmatch
EXTRACTION = ("blur3d", "dogs_extrema", "gather_eig", "canonical", "rotated_goh", "goh")
MATCH = ("knn_prep_i8", "knn_topk_int8", "knn_topk_f32", "ratio_match_int8", "ratio_match_f32", "hough")


def launch_counts(labels) -> dict:
    """{label: the launches of its ENTRIES so far}, from cuda_lib's counts."""
    from sift3d_torch.kernels.cuda_lib import launches

    return {k: sum(launches(e) for e in ENTRIES[k]) for k in labels}


def launches_since(before: dict) -> dict:
    """{label: its launches since `before`, a launch_counts}."""
    now = launch_counts(before)
    return {k: now[k] - before[k] for k in before}


def run_cli(argv, workdir: str, device=None):
    """featextract.main(argv) in workdir (where --debug-pgm writes), its
    output swallowed; returns (rc, wall ms)."""
    import torch

    from sift3d_torch.cli import featextract

    here = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = featextract.main(argv, device=device)
        torch.cuda.synchronize()
        return rc, (time.perf_counter() - t0) * 1e3
    finally:
        os.chdir(here)


# the kernels only the GoH descriptor runs, and the ones only BRIEF runs
GOH_ONLY, BRIEF_ONLY = ("rotated_goh", "goh"), ("rotated_brief", "brief")
BRIEF_FLAGS = {"-b": "brief", "-br": "rrief", "-bn": "nrrief"}


def cli_full_width(vol_np, labels, tmp: str):
    """Phase 7: the CLI on the card with the flags at full width. labels
    names the main path's kernels, the fused BRIEF kernels, K10
    (double_size_batch), K11 (isotropic_resample_batch) and K4's patch
    mode (sample_rotated, on no path): the GoH flags must launch all but
    the BRIEF kernels, -b, -br and -bn all but the GoH ones, -2+ alone K10,
    -w and -ws alone K11 (once a call), none K4's patch mode. Then the
    descriptors stage of extract_features with each BRIEF variant under
    torch.profiler: its launch calls and device ms. Returns the .key rows
    and the launches of each flag."""
    from sift3d_torch.io import keyfile, nifti

    t1 = os.path.join(tmp, "t1.nii")
    nifti.write(t1, vol_np)
    aniso = os.path.join(tmp, "t1_aniso.nii")
    write_aniso(aniso, vol_np[::2], seed=4)
    rows_of, launches_of = {}, {}
    for flag, path in (("-2+", t1), ("-w", aniso), ("-ws", aniso), ("-2-", t1), ("-b", t1), ("-br", t1),
                       ("-bn", t1)):
        walls = []
        for _ in range(2):
            before = launch_counts(labels)
            rc, ms = run_cli([flag, path, "out.key"], tmp)
            walls.append(ms)
            launches = launches_since(before)
            if rc != 0:
                raise AssertionError(f"the CLI failed with {flag}: rc {rc}")
        with open(os.path.join(tmp, "out.key")) as f:
            head = [next(f) for _ in range(2)]
        rows = len(keyfile.read_text(os.path.join(tmp, "out.key"))[0])
        print(
            f"phase7 CLI {flag} {os.path.basename(path)} on the card: wall_ms {walls!r}; "
            f"{rows} .key rows; {head[1].strip()}; launches {json.dumps(launches)}"
        )
        idle = (GOH_ONLY if flag in BRIEF_FLAGS else BRIEF_ONLY) + ("sample_rotated",)
        idle += () if flag == "-2+" else ("double_size_batch",)
        idle += () if flag in ("-w", "-ws") else ("isotropic_resample_batch",)
        if (rows == 0 or any((launches[k] > 0) == (k in idle) for k in launches)
                or launches["isotropic_resample_batch"] > 1):
            raise AssertionError(f"the CLI with {flag} did not run its kernels: {launches}, {rows} rows")
        rows_of[flag], launches_of[flag] = rows, launches
    import torch

    from sift3d_torch.core.config import DEFAULT_CONFIG
    from sift3d_torch.pipeline.extract import extract_features

    vol = torch.from_numpy(vol_np).cuda()
    for descriptor in ("goh", *BRIEF_FLAGS.values()):
        prof = device_profile(lambda: extract_features(vol, DEFAULT_CONFIG, descriptor=descriptor))
        got = "not measured (no device events)" if prof is None else (
            "{} launch calls in {} calls, ".format(*prof[5]["descriptors"])
            + f"{prof[6].get('descriptors')!r} device ms")
        print(f"phase7 extract_features {descriptor}: the descriptors stage {got}")
    return rows_of, launches_of


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def cli_card_vs_cpu(labels, tmp: str) -> None:
    """Phase 8: every flag, the CLI on the card against the CLI on the CPU,
    on tests/test_torch_cli_flags.py's 64^3-grid volumes."""
    import numpy as np

    from sift3d_torch.io import keyfile, nifti
    from sift3d_torch.utils.synthetic import synthetic_volume

    vols = {
        "cube64": lambda p: nifti.write(p, synthetic_volume(64, seed=7)),
        "cube32": lambda p: nifti.write(p, np.ascontiguousarray(synthetic_volume(64, seed=3)[::2, ::2, ::2])),
        "cube128": lambda p: nifti.write(p, synthetic_volume(128, seed=7)),
        "aniso": lambda p: write_aniso(p, synthetic_volume(64, seed=7)[::2], seed=4),
    }
    paths = {}
    for name, write in vols.items():
        paths[name] = os.path.join(tmp, f"{name}.nii")
        write(paths[name])
    cells = [("-2+", "cube32"), ("-w", "aniso"), ("-ws", "aniso"), ("-2-", "cube128"),
             ("-b", "cube64"), ("-br", "cube64"), ("-bn", "cube64"), ("--debug-pgm", "cube64")]
    for flag, name in cells:
        dirs = {who: tempfile.mkdtemp(prefix=f"{who}_", dir=tmp) for who in ("card", "cpu")}
        before = launch_counts(labels)
        rc_card, _ = run_cli([flag, paths[name], "out.key"], dirs["card"])
        launched = sum(launches_since(before).values())
        rc_cpu, _ = run_cli([flag, paths[name], "out.key"], dirs["cpu"], device="cpu")
        card, cpu = (keyfile.read_text(os.path.join(dirs[w], "out.key"))[0] for w in ("card", "cpu"))
        same = len(card) == len(cpu) > 0
        geo = same and bool((card.xyz == cpu.xyz).all() and (card.scale == cpu.scale).all())
        desc = float((card.desc == cpu.desc).all(axis=1).mean()) if same else 0.0
        key_eq = same_bytes(os.path.join(dirs["card"], "out.key"), os.path.join(dirs["cpu"], "out.key"))
        pgms = sorted(f for f in os.listdir(dirs["cpu"]) if f.endswith(".pgm"))
        pgm_eq = pgms == sorted(f for f in os.listdir(dirs["card"]) if f.endswith(".pgm")) and all(
            open(os.path.join(dirs["card"], f), "rb").read() == open(os.path.join(dirs["cpu"], f), "rb").read()
            for f in pgms
        )
        print(
            f"phase8 CLI {flag} {name}: card rc {rc_card}, {len(card)} rows; cpu rc {rc_cpu}, "
            f"{len(cpu)} rows; equal locations and scales {geo}; identical descriptors {desc!r}; "
            f".key files byte-identical {key_eq} (required); "
            f"{len(pgms)} PGM files equal {pgm_eq}"
        )
        if not (rc_card == 0 and rc_cpu == 0 and launched > 0 and geo and desc == 1.0 and pgm_eq
                and key_eq):
            raise AssertionError(f"the CLI with {flag} on the card disagrees with the CLI on the CPU")
        if flag == "--debug-pgm" and len(pgms) < 2:
            raise AssertionError("--debug-pgm wrote no PGM files")


def dogs_stack_rows(vol, cfg):
    """(gstack, dogs, lvl, zyx) of the octave-0 candidates of vol."""
    from sift3d_torch.kernels import extrema_cuda
    from sift3d_torch.pipeline import features, pyramid

    gstack, _, _, _ = pyramid.octave_core(pyramid.initial_blur_core(vol, cfg), cfg)
    dogs, mask = extrema_cuda.dogs_extrema(gstack.contiguous())
    lvl, zyx, _ = features.candidate_table(mask)
    return gstack, dogs, lvl, zyx


def spatial_runs(vol, cfg, key_rows_2p: int) -> dict:
    """Phase 9: Z-sharded extraction on a 4-shard mesh on cuda:0 against
    extract_features on the card, both with prescale "double" (-2+) and
    without. Returns the launches of the -2+ run."""
    import numpy as np
    import torch

    from sift3d_torch.dist import halo, spatial
    from sift3d_torch.dist.mesh import make_mesh
    from sift3d_torch.pipeline import extract, pyramid
    from sift3d_torch.pipeline.extract import extract_features
    from sift3d_torch.utils.synthetic import repeatability, synthetic_volume

    labels = ("extrema_mask",) + EXTRACTION
    n = 4
    mesh = make_mesh(n, ["cuda:0"])
    dev = mesh[0]
    first = None
    for label, prescale, octaves in (("-2+", "double", None), ("T1", None, 3)):
        # the extraction grid and its initial image scale, as the pipeline makes them
        img = extract.prescaled_volume(vol, prescale, dev)
        scale = extract._initial_scale(prescale)
        zd, yd, xd = img.shape
        k = spatial.sharded_octave_count(img.shape, cfg, octaves)
        n_oct = pyramid.num_octaves(img.shape, cfg)
        zp = -(-zd // (n * 2**k)) * (n * 2**k)
        # the sharded octaves' pyramids, gathered, against the single-device ones
        padded = torch.cat([img, img.new_zeros((zp - zd, yd, xd))])
        base = spatial.initial_blur_spatial(halo.shard_volume(padded, mesh), cfg, zd, scale)
        del padded
        want = pyramid.initial_blur_core(img, cfg, scale)
        true_z, equal = zd, []
        for _ in range(k):
            octv = spatial.octave_step_spatial(base, cfg, true_z)
            gstack, _, mask, nxt = pyramid.octave_core(want, cfg)
            equal.append(bool(torch.equal(halo.planes(octv.gstack, 0, true_z, dev), gstack)
                              and torch.equal(halo.planes(octv.mask, 0, true_z, dev), mask)))
            base, want, true_z = octv.next_base, nxt, true_z // 2
            del octv, gstack, mask
        del base, want
        single_walls = []
        torch.cuda.reset_peak_memory_stats()
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = extract_features(vol, cfg, dev, prescale=prescale)
            torch.cuda.synchronize()
            single_walls.append((time.perf_counter() - t0) * 1e3)
        single_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for rep in range(2):
            before = launch_counts(labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = spatial.extract_features_spatial(vol, mesh, cfg, sharded_octaves=octaves, prescale=prescale)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = launches_since(before)
        peak = torch.cuda.max_memory_allocated()
        tz, halo_planes = zp // n, spatial.sampling_halo(cfg)
        # one shard's octave-0 pyramid (6 Gaussian + 5 DoG f32 + 3 mask
        # bytes per voxel) and its feature stage's Gaussian slab
        shard_bytes = (6 * 4 + 5 * 4 + 3) * tz * yd * xd
        slab_bytes = 6 * 4 * min(tz + 2 * halo_planes, zd) * yd * xd
        same = len(feats) == len(single) > 0
        geo = same and bool((feats.xyz == single.xyz).all() and (feats.scale == single.scale).all()
                            and (feats.info == single.info).all())
        desc = float((feats.desc == single.desc).all(axis=1).mean()) if same else 0.0
        d_ori = float(np.abs(feats.ori - single.ori).max()) if same else float("inf")
        d_eig = float(np.abs(feats.eigs - single.eigs).max()) if same else float("inf")
        key_rows = int(feats.eig_mask(cfg.eig_threshold).sum())
        print(
            f"phase9 spatial {label} {tuple(img.shape)} on {n} shards of cuda:0, {k} of {n_oct} "
            f"octaves sharded (Z padded to {zp}, tz {tz}, sampling halo {halo_planes}): wall_ms "
            f"{walls!r} (extract_features {single_walls!r}); {len(feats)} features, {key_rows} .key "
            f"rows; extract_features {len(single)}; "
            f"sharded octaves' gathered stacks and masks bit-equal {equal}; equal locations, scales "
            f"and flags {geo}; identical descriptors {desc!r}; max orientation diff {d_ori!r}, "
            f"eigenvalue diff {d_eig!r} (exact); device "
            f"peak {peak} B (extract_features {single_peak} B); per shard: octave-0 pyramid "
            f"{shard_bytes} B, feature-stage Gaussian slab {slab_bytes} B; launches {json.dumps(launches)}"
        )
        ok = (all(equal) and len(equal) == k and geo and desc == 1.0 and d_ori == 0.0 and d_eig == 0.0
              and launches["extrema_mask"] == n * k and launches["dogs_extrema"] == n_oct - k
              and min(launches.values()) > 0)
        if label == "-2+":
            ok = ok and key_rows == key_rows_2p
            first = launches
        if not ok:
            raise AssertionError(f"the spatial path on the {label} grid disagrees with extract_features")
        del feats, single

    small = synthetic_volume(64)
    on_gpu = spatial.extract_features_spatial(small, mesh, cfg, sharded_octaves=2)
    on_cpu = spatial.extract_features_spatial(small, make_mesh(n, ["cpu"]), cfg, sharded_octaves=2)
    same = len(on_gpu) == len(on_cpu) > 0
    rep = (repeatability(on_gpu, on_cpu)[0], repeatability(on_cpu, on_gpu)[0]) if same else (0.0, 0.0)
    desc = float((on_gpu.desc == on_cpu.desc).all(axis=1).mean()) if same else 0.0
    d_ori = float(np.abs(on_gpu.ori - on_cpu.ori).max()) if same else float("inf")
    print(
        f"phase9 spatial card vs cpu on synthetic_volume(64), 2 of 4 octaves sharded over {n} "
        f"shards: counts {len(on_gpu)} / {len(on_cpu)}; repeatability {rep!r}; identical "
        f"descriptors {desc!r}; max orientation diff {d_ori!r} (exact)"
    )
    if not (same and rep == (1.0, 1.0) and desc == 1.0 and d_ori == 0.0):
        raise AssertionError("spatial on the card disagrees with spatial on the CPU")

    count = torch.cuda.device_count()
    if count >= 2:
        cards = make_mesh()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        feats = spatial.extract_features_spatial(vol, cards, cfg, sharded_octaves=3)
        peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
        single = extract_features(vol, cfg, dev)
        same = len(feats) == len(single) > 0 and bool((feats.xyz == single.xyz).all())
        print(
            f"phase9 spatial T1 over {count} cards: {len(feats)} features, equal to one card "
            f"{same}; device peak per shard's card {peaks} B"
        )
        if not same:
            raise AssertionError("the spatial path over several cards disagrees with one card")
    else:
        print("phase9 multi-card transport not run: this machine has one CUDA card")
    return first


def shifted_volumes(base, n: int = 32):
    """Phase 10's and 12's volumes on the T1 grid, on base's device: image 0
    the blob texture, images 1..n-1 copies rolled by distinct integer shifts
    of at most 4 voxels plus unit Gaussian noise (seeded). Returns (volumes,
    the shifts of images 1..n-1)."""
    import numpy as np
    import torch

    grid = [(dz, dy, dx) for dz in range(-4, 5) for dy in range(-4, 5) for dx in range(-4, 5) if (dz, dy, dx) != (0, 0, 0)]
    shifts = [grid[i] for i in np.random.default_rng(3).choice(len(grid), 31, replace=False)][: n - 1]
    vols = [base]
    for i, shift in enumerate(shifts, 1):
        gen = torch.Generator(device=base.device).manual_seed(100 + i)
        vols.append(torch.roll(base, shift, dims=(0, 1, 2)) + torch.randn(base.shape, generator=gen, device=base.device))
    return vols, shifts


def compare_batched(base, cfg) -> list:
    """Phase 2's batched rows: K1 on the octave-0 stacks of four T1-grid
    volumes (phase 12's first four) as one [4, 6, 182, 218, 182] batch, the
    fused K2 on their candidate union (volume index vi, the last volume's
    rows included) and the fused K4 on the union's reoriented rows over the
    flattened [24, 182, 218, 182] stack; then the same three on a batch
    whose first volume (zeros) has no candidate and whose second is T1.
    Each exact against its plain version on the same tensors and against
    per-volume launches of the same kernel. Returns the kernel table's rows
    dogs_extrema_batch, gather_eig_union and rotated_goh_union."""
    import torch

    from sift3d_torch.kernels import extrema_cuda, patch_cuda
    from sift3d_torch.pipeline import features, pyramid

    results = []
    record = functools.partial(record_kernel, results)
    vols, _ = shifted_volumes(base, 4)
    sig = tuple(cfg.level_sigmas())
    s = cfg.max_primary_orientations * cfg.max_secondary_orientations

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for label, batch in (("four T1-grid volumes", torch.stack(vols)),
                         ("zeros, then T1", torch.stack([torch.zeros_like(base), vols[3]]))):
        nb = batch.shape[0]
        gstack, _, _, _ = pyramid.octave_core(pyramid.initial_blur_core(batch, cfg), cfg)
        vox = gstack[:, 0].numel()
        record(
            "dogs_extrema_batch", "sift3d_torch/csrc/dogs_extrema.cu", "sift3d/kernels/extrema_pallas.py:284",
            lambda: extrema_cuda.dogs_extrema(gstack), lambda: extrema_cuda.dogs_extrema_plain(gstack),
            0.0, f"{label}: octave-0 gstack {tuple(gstack.shape)} (exact)", 47 * vox, 5 * vox,
        )
        dogs, mask = extrema_cuda.dogs_extrema(gstack)
        per_volume = [same((dogs[b], mask[b]), extrema_cuda.dogs_extrema(gstack[b].contiguous())) for b in range(nb)]
        vi, lvl, zyx, _, _ = features.candidate_union(mask)
        zyx = zyx.contiguous()
        counts = torch.bincount(vi, minlength=nb).tolist()
        out = features.gather_eig(gstack, dogs, lvl, zyx, sig, cfg, vi=vi)
        xyz, scale_, in_bounds, pn, _, _, keep = out
        n, flat = lvl.shape[0], gstack.flatten(0, 1)
        glvl = vi * gstack.shape[1] + lvl
        touched = touched_voxels(flat.shape, glvl, *patch_points(glvl, xyz, scale_))
        record(
            "gather_eig_union", "sift3d_torch/csrc/identity_eig.cu", "sift3d/kernels/patch.py:375",
            lambda: features.gather_eig(gstack, dogs, lvl, zyx, sig, cfg, vi=vi),
            lambda: features.gather_eig_plain(gstack, dogs, lvl, zyx, sig, cfg, vi=vi),
            0.0, f"{label}: octave-0 candidate union, {n} rows, per volume {counts} (exact)",
            (GATHER_EIG_ROW_BYTES + 8) * n + 4 * touched_dogs(dogs.flatten(0, 1).shape, vi * dogs.shape[1] + lvl, zyx)
            + 4 * touched, GATHER_EIG_ROW_FLOPS * n,
        )
        for b in range(nb):
            sel = vi == b
            if not sel.any():
                continue
            single = features.gather_eig(gstack[b].contiguous(), dogs[b].contiguous(), lvl[sel], zyx[sel], sig, cfg)
            per_volume.append(same([t[sel] for t in out], single))
        kidx = torch.nonzero(in_bounds & keep)[:, 0]
        o = features.canonical_stage(pn[kidx], cfg)
        row, slot = features.reoriented_slots(o["ori_valid"], cfg)
        rvi = vi[kidx][row]
        rrows = [glvl[kidx][row].to(torch.int32), xyz[kidx][row], scale_[kidx][row],
                 o["ori"].reshape(-1, s, 3, 3)[row, slot].contiguous()]
        nr = row.shape[0]
        touched = touched_voxels(flat.shape, rrows[0], *patch_points(*rrows))
        record(
            "rotated_goh_union", "sift3d_torch/csrc/rotated_goh.cu", "sift3d/kernels/patch.py:889",
            lambda: patch_cuda.rotated_goh(flat, *rrows), lambda: patch_cuda.rotated_goh_plain(flat, *rrows),
            0.0, f"{label}: {nr} reoriented rows of the union on the flattened stack {tuple(flat.shape)}, "
            f"per volume {torch.bincount(rvi, minlength=nb).tolist()} (exact)",
            56 * nr + 4 * touched + 64 * nr, (42 * 1331 + GOH_ROW_FLOPS) * nr,
        )
        got = patch_cuda.rotated_goh(flat, *rrows)
        for b in range(nb):
            sel = rvi == b
            if not sel.any():
                continue
            local = [(rrows[0][sel] - b * gstack.shape[1]).contiguous(), *(t[sel] for t in rrows[1:])]
            per_volume.append(torch.equal(got[sel], patch_cuda.rotated_goh(gstack[b].contiguous(), *local)))
        print(f"phase2 batched {label}: K1, the fused K2 and the fused K4 equal to per-volume launches: "
              f"{per_volume}")
        if not all(per_volume) or (nb == 4 and min(counts) == 0) or (nb == 2 and counts[0] != 0):
            raise AssertionError(f"the batched kernels differ from per-volume launches on {label}: {per_volume}")
        del gstack, dogs, mask, flat, pn, out
    return table_rows(results)


MATCH_ROWS = 48_000  # 32 images x 1500 features: MATCHBENCH_r05.json's largest cell (its sizes only)
HOUGH_PAIRS = 31  # the pairs of one featmatch call on 32 images
HOUGH_STAGE_OPS = (34, 60, 4)  # ops a pair: the distance test, the orientation test, the scale test
HOUGH_HYPOTHESIS_OPS = 169  # ops a hypothesis formed: two triangle frames, R1^T R0, the perimeters' ratio


def similarity_matches(m: int, seed: int):
    """m putative matches (pts0, pts1, s0, s1, o0, o1) of a similarity
    (scale 1.1, 15 degrees about a random axis, a shift) with location and
    orientation noise and a third of them relocated at random."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rot = rotation(seed)
    o0 = np.stack([rotation(seed * 10_000 + i) for i in range(m)])
    p0 = rng.uniform(20, 160, (m, 3))
    s0 = rng.uniform(1.5, 8.0, m)
    p1 = 1.1 * p0 @ rot.T + np.array([3.0, -2.0, 5.0]) + rng.normal(0, 1.0, (m, 3))
    p1[: m // 3] = rng.uniform(20, 160, (m // 3, 3))
    o1 = np.einsum("ij,njk->nik", rot, o0.transpose(0, 2, 1)).transpose(0, 2, 1) + rng.normal(0, 0.1, (m, 3, 3))
    s1 = 1.1 * s0 * np.exp(rng.normal(0, 0.2, m))
    return [np.ascontiguousarray(a, np.float32) for a in (p0, p1, s0, s1, o0, o1)]


def tiled_goh_rows(feats):
    """M1's first phase-2 input: the extraction's GoH rows tiled to
    MATCH_ROWS rows."""
    import numpy as np

    return np.tile(feats.desc, (-(-MATCH_ROWS // len(feats)), 1))[:MATCH_ROWS]


def stacked_hough_args(sizes, dev):
    """M3's inputs for a stack of pairs, one of m matches for each m in
    sizes (similarity_matches, seeds 1, 2, ...): the matches on dev (M3
    forms their hypotheses itself); and the offsets."""
    import numpy as np
    import torch

    from sift3d_torch.match import hough

    pairs = [similarity_matches(m, seed=i + 1) for i, m in enumerate(sizes)]
    cat = [np.concatenate([p[f] for p in pairs]) for f in range(6)]
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in cat]
    return args, hough.segment_offsets(sizes)


def same_bits(a, b) -> bool:
    """a and b (tensors) equal bit for bit: f32 values as int32 views."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


def knn_int8_work(nq: int, n: int, c: int, k: int):
    """(bytes, f32 FLOPs, int8 operations) of M1's int8 route: the rows read
    once and the results written once; the tensor-core product over 64
    columns; a distance's sum, product and difference (and the geometry
    tail's three fmas), and the norms."""
    return ((nq + n) * c * 4 + nq * k * 12, nq * n * (3 + 2 * (c - 64)) + 2.0 * (nq + n) * c,
            2.0 * nq * n * 64)


def compare_matching(feats, cfg, dev):
    """Phase 2 for the matching kernels, each against its plain version on
    the same CUDA tensors, exact: M1 (kNN, k = 5) on its int8 route at
    MATCH_ROWS rows all to all, on the extraction's GoH rows tiled, on rows
    from a 4-letter alphabet (tie heavy) and on 67-column -g rows, then a
    quarter shard (MATCH_ROWS / 4 queries, the database cut into slices),
    and on its f32 route on float rows (which its int8 wrapper must
    refuse); M2 on 31 stacked query sets against
    one database; M3's scores on stacks of 31 pairs of 1000 and of 3000
    matches (beside 31 single-pair launches) and on single pairs of M = 1500
    and 3000, and its inlier masks and winners on both stacks' winners.
    Returns the table's rows."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import knn_cuda
    from sift3d_torch.match import hough, pairwise

    results = []
    record = functools.partial(record_kernel, results)
    rng = np.random.default_rng(5)
    n = MATCH_ROWS
    reps = -(-n // len(feats))
    goh = tiled_goh_rows(feats)
    # the -g columns: each tiled copy as another image, shifted by up to 4 voxels
    xyz = (np.tile(feats.xyz, (reps, 1)) + np.repeat(rng.integers(-4, 5, (reps, 3)), len(feats), 0))[:n]
    scale = np.tile(feats.scale, reps)[:n]
    sets = {
        "GoH rows tiled": goh,
        "4-letter alphabet": rng.choice(np.float32([0, 1, 2, 3]), (n, 64)),
        "-g 0.5 (67 columns)": np.concatenate([goh, 0.5 * xyz / scale[:, None]], axis=1),
        "float rows": rng.standard_normal((n, 64)).astype(np.float32) * 20,
    }
    k = cfg.knn_neighbors
    for label, rows in sets.items():
        x = torch.as_tensor(np.ascontiguousarray(rows), dtype=torch.float32, device=dev)
        c = x.shape[1]
        int8 = knn_cuda.int8_route(x, x)
        if int8 != (label != "float rows"):
            raise AssertionError(f"M1 on {label} took the {'int8' if int8 else 'f32'} route")
        if not int8:
            try:
                knn_cuda.knn_topk_int8(x, x, k)
            except ValueError:
                pass
            else:
                raise AssertionError(f"M1's int8 wrapper took {label}")
        queries = [(x, f"all to all over {n} rows x {c}")]
        if label == "GoH rows tiled":
            queries.append((x[: n // 4], f"a quarter shard, {n // 4} queries x {n} rows x {c}"))
        for q, shape in queries:
            wrapper = knn_cuda.knn_topk_int8 if int8 else knn_cuda.knn_topk_f32
            before = launch_counts(("knn_prep_i8", "knn_topk_int8") if int8 else ("knn_topk_f32",))
            dist, _ = wrapper(q, x, k)
            torch.cuda.synchronize()
            launches = sum(launches_since(before).values())
            slices = knn_cuda.int8_plan(q.shape[0], n, knn_cuda.int8_places(dev, c, k))[0] if int8 else 1
            if q is not x and slices < 2:
                raise AssertionError(f"M1 did not cut the database for the quarter shard: {slices} slice")
            ties = float((dist[:, 1:] == dist[:, :-1]).float().mean())
            nq = q.shape[0]
            n_bytes, flops, int8_ops = knn_int8_work(nq, n, c, k) if int8 else (
                (nq + n) * c * 4 + nq * k * 12, 2.0 * nq * n * c, 0.0)
            record(
                "knn_topk_int8" if int8 else "knn_topk_f32", "sift3d_torch/csrc/knn_topk.cu",
                "sift3d/match/knn.py:20",
                lambda: wrapper(q, x, k), lambda: knn_cuda.knn_topk_plain(q, x, k),
                0.0, f"{label}: {shape}, k={k}, route {'int8' if int8 else 'f32'}, {slices} database "
                f"slice(s), {launches} launches a call, {ties:.3f} of neighbour pairs tied (exact)",
                n_bytes, flops, int8_ops=int8_ops,
                library=lambda: torch.topk(torch.cdist(q, x), k, dim=1, largest=False), plain_reps=2,
            )
        del x, dist

    # M2: 31 query sets of about 1000 rows (near-copies of the database's
    # rows: a few ranks swapped, locations jittered) against one database
    db = feats.select(np.arange(min(1000, len(feats))))
    q = np.tile(db.desc, (31, 1))
    swap = rng.integers(0, 64, (q.shape[0], 3, 2))
    for a, b in swap.transpose(1, 2, 0):
        rows = np.arange(q.shape[0])
        q[rows, a], q[rows, b] = q[rows, b], q[rows, a]
    put = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    qt, dbt, xyzt, st = (put(np.ascontiguousarray(a)) for a in (q, db.desc, db.xyz, db.scale))
    thr, shift = float(np.float32(cfg.ratio_compat_log_scale)), float(cfg.ratio_compat_shift)
    nq, nd = q.shape[0], len(db)
    # M2 on its int8 route (the .key rows of featmatch), then on float rows
    # of the same shape (its f32 route); each with its route and launches
    for name, qr, dr in (("ratio_match_int8", qt, dbt), ("ratio_match_f32", qt + 0.25, dbt + 0.25)):
        int8 = knn_cuda.int8_route(qr, dr)
        if int8 != (name == "ratio_match_int8"):
            raise AssertionError(f"M2 took the {'int8' if int8 else 'f32'} route for {name}")
        before = launch_counts(("knn_prep_i8", name) if int8 else (name,))
        pairwise.ratio_rows(qr, dr, xyzt, st, thr, shift)
        torch.cuda.synchronize()
        per_call = sum(launches_since(before).values())
        n_bytes = nq * 64 * 4 + nd * (64 * 4 + 16) + nq * 12
        # the wrapper's times hold its route check (a host read); the launches alone:
        alone = (f"; its pre-pass and kernel without the route check "
                 f"{burst_ms(lambda: pairwise._int8(qr, dr, xyzt, st, thr, shift))!r} ms b2b" if int8 else "")
        # int8: the product on the tensor cores, then a distance's sum, product
        # and difference a pair; f32: the fma chains
        flops, int8_ops = (3.0 * nq * nd, 2.0 * nq * nd * 64) if int8 else (2.0 * nq * nd * 64, 0.0)
        record(
            name, "sift3d_torch/csrc/ratio_match.cu", "sift3d/match/pairwise.py:112",
            lambda: pairwise.ratio_rows(qr, dr, xyzt, st, thr, shift),
            lambda: pairwise.ratio_rows_plain(qr, dr, xyzt, st, thr, shift),
            0.0, f"31 stacked query sets, {nq} rows, against {nd} database rows, route "
            f"{'int8' if int8 else 'f32'}, {per_call} launches a call; [events, device ms an "
            f"event] of the kernel over 10 profiled calls "
            f"{kernel_device_ms(lambda: pairwise.ratio_rows(qr, dr, xyzt, st, thr, shift), 'ratio_')}{alone} (exact)",
            n_bytes, flops, int8_ops=int8_ops,
            library=lambda: pairwise.closed_form(torch.cdist(qr, dr).square(), xyzt, st, thr, shift),
        )
    ratio_edges(dev, thr, shift)

    # M3's scores on stacks of 31 pairs (featmatch's one launch a call) and
    # on single pairs at the pairwise path's largest M (max_matches) and half
    # of it; the inlier masks and winners on each stack's winners
    th = tuple(float(np.float32(t)) for t in (cfg.hough_thres_scale, cfg.hough_thres_trans, cfg.hough_thres_orien))
    big = cfg.max_matches
    for sizes, label in (([1000] * HOUGH_PAIRS, f"{HOUGH_PAIRS} pairs x 1000 matches, stacked"),
                         ([big] * HOUGH_PAIRS, f"{HOUGH_PAIRS} pairs x {big} matches, stacked"),
                         ([1500], "one pair, M=1500"), ([big], f"one pair, M={big}")):
        args, offsets = stacked_hough_args(sizes, dev)
        m = int(offsets[-1])
        # the pairs each test stage reaches (the kernel skips the later
        # tests of a pair that fails an earlier one)
        reach = [int(hough.hough_scores_plain(*args, t, offsets).sum()) for t in
                 ((float("inf"), th[1], float("-inf")), (float("inf"), th[1], th[2]))]
        scores = hough.hough_scores(*args, th, offsets)
        if not same_bits(scores, hough.hough_scores_plain(*args, th, offsets)):
            raise AssertionError(f"M3's scores differ from the plain version's at {label}")
        ops = HOUGH_STAGE_OPS[0] * sum(s * s for s in sizes) + HOUGH_STAGE_OPS[1] * reach[0] \
            + HOUGH_STAGE_OPS[2] * reach[1] + HOUGH_HYPOTHESIS_OPS * m
        blocks = int(hough.segment_blocks(offsets)[-1])
        extra = ""
        if len(sizes) > 1:
            bounds = list(zip(offsets[:-1].tolist(), offsets[1:].tolist()))

            def per_pair():
                for lo, hi in bounds:
                    hough.hough_scores(*(a[lo:hi] for a in args), th)

            extra = (f"; {len(sizes)} single-pair launches {median_ms(per_pair)!r} ms "
                     f"({burst_ms(per_pair, n=5)!r} b2b)")
        record(
            "hough_scores", "sift3d_torch/csrc/hough_scores.cu", "sift3d/match/hough.py:58",
            lambda: hough.hough_scores(*args, th, offsets), lambda: hough.hough_scores_plain(*args, th, offsets),
            0.0, f"{label}, {blocks} blocks (best score {int(scores.max())}; pairs past the distance test "
            f"{reach[0]}, past the orientation test {reach[1]}); [events, device ms an event] of the kernel "
            f"over 10 profiled calls {kernel_device_ms(lambda: hough.hough_scores(*args, th, offsets), 'hough')}"
            f"{extra} (exact)",
            m * 26 * 4 + m * 4, ops, chain=lambda: hough.hough_scores_plain(*args, th, offsets),
            plain_reps=2,
        )
        if len(sizes) > 1:
            s = scores.cpu().numpy()
            winners = [lo + int(np.argmax(s[lo:hi])) for lo, hi in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
            mask, rs = hough.hough_inliers(*args, th, offsets, winners)
            if int(mask.sum()) != int(s[winners].sum()):
                raise AssertionError("M3's inlier masks disagree with its scores")
            if not all(map(same_bits, (mask, rs), hough.hough_inliers_plain(*args, th, offsets, winners))):
                raise AssertionError(f"M3's inlier masks or winners differ from the plain version's at {label}")
            mreach = [int(hough.hough_inliers_plain(*args, t, offsets, winners)[0].sum()) for t in
                      ((float("inf"), th[1], float("-inf")), (float("inf"), th[1], th[2]))]
            record(
                "hough_inliers", "sift3d_torch/csrc/hough_scores.cu", "sift3d/match/hough.py:95",
                lambda: hough.hough_inliers(*args, th, offsets, winners),
                lambda: hough.hough_inliers_plain(*args, th, offsets, winners),
                0.0, f"the winners' masks, {label}, {int(hough.segment_blocks(offsets, True)[-1])} blocks, "
                f"{int(mask.sum())} inliers, the winners' rotations and scales formed on the card; [events, "
                f"device ms an event] of the kernel over 10 profiled calls "
                f"{kernel_device_ms(lambda: hough.hough_inliers(*args, th, offsets, winners), 'hough')} "
                f"(exact, the winners bit for bit)",
                m * 26 * 4 + len(sizes) * 10 * 4 + m,
                HOUGH_STAGE_OPS[0] * m + HOUGH_STAGE_OPS[1] * mreach[0] + HOUGH_STAGE_OPS[2] * mreach[1]
                + HOUGH_HYPOTHESIS_OPS * len(sizes),
                chain=lambda: hough.hough_inliers_plain(*args, th, offsets, winners),
            )
    return table_rows(results)


def ratio_edges(dev, thr: float, shift: float) -> None:
    """Phase 2 edge shapes of M2, each exact against its plain version on
    both routes: 600 queries against D in {2, 3, 127, 128, 129, 969} rows
    of a 3-letter alphabet (heavy ties; a third of the database repeated,
    row 1 a copy of row 0 for D < 6; positions close enough that many events
    are compatible and the partner changes inside a tile; tiles and halves
    cut mid-way; half the scales e^log_thr times the others', up to 1e-3
    off, so scale ratios fall in and beside the compatibility test's band),
    and D = 9000 (more rows than the int8 kernel keeps geometry for in
    shared memory: its second path)."""
    import numpy as np
    import torch

    from sift3d_torch.match import pairwise

    errs = {}
    for d in (2, 3, 127, 128, 129, 969, 9000):
        rng = np.random.default_rng(d)
        db = rng.integers(0, 3, (d, 64)).astype(np.float32)
        k = max(1, d // 3)
        db[k : 2 * k] = db[:k]
        q = np.concatenate([db[rng.integers(0, d, 300)], rng.integers(0, 3, (300, 64))]).astype(np.float32)
        xyz = rng.uniform(0, 4, (d, 3)).astype(np.float32)
        # scales whose ratios fall near e^+-log_thr: the compatibility test's band and f64 log
        band = np.float32(np.exp(np.float64(thr))) * (1.0 + rng.choice([0.0, 1e-6, -1e-6, 1e-3, -1e-3], d))
        scale = (2.0 * np.where(rng.random(d) < 0.5, band, 1.0)).astype(np.float32)
        qt, dbt, xt, st = (torch.as_tensor(a, device=dev) for a in (q, db, xyz, scale))
        for route, (qr, dr) in (("int8", (qt, dbt)), ("f32", (qt * 0.37, dbt * 0.37))):
            wrapper = pairwise.ratio_rows_int8 if route == "int8" else pairwise.ratio_rows_f32
            got = wrapper(qr, dr, xt, st, thr, shift)
            want = pairwise.ratio_rows_plain(qr, dr, xt, st, thr, shift)
            errs[f"D={d} {route}"] = max(max_abs(a.float(), b.float()) for a, b in zip(got, want))
    print(f"phase2 ratio_match edge shapes, 600 tie-heavy queries: max_abs_err {json.dumps(errs)} (exact)")
    if max(errs.values()) != 0.0:
        raise AssertionError(f"M2 differs from its plain version at an edge shape: {errs}")


def launch_timer(labels):
    """A tracer (``utils.timing.Tracer``; record inside its ``record()``)
    that also counts the launches of each label (``ENTRIES``) in each
    stage; milliseconds() gives each stage's host ms."""
    from sift3d_torch.utils.timing import Tracer

    class LaunchTimer(Tracer):
        def __init__(self):
            super().__init__()
            self.by_stage = {}

        @contextlib.contextmanager
        def stage(self, name: str):
            before = launch_counts(labels)
            with super().stage(name):
                yield
            got = self.by_stage.setdefault(name, dict.fromkeys(labels, 0))
            for k, n in launches_since(before).items():
                got[k] += n

        def milliseconds(self):
            return {name: t.host_ms for name, t in self.totals().items()}

    return LaunchTimer()


def featmatch_full_width(base, cfg, dev, tmp: str) -> dict:
    """Phase 10: 32 volumes on the 182x218x182 grid (image 0 the blob
    texture, images 1-31 copies rolled by distinct integer shifts of at
    most 4 voxels plus seeded noise), extracted on the card and written as
    .key files; then featmatch --all-to-all --refine on them, twice, and
    once without --refine. Every pair's refined translation must be its
    shift within 1 voxel and its scale 1 within 5%. Without --refine the
    transform is the single winning Hough hypothesis, whose rotation comes
    from one feature pair's orientation frames: its error is printed, not
    held (a rotation off by a few degrees moves the translation about the
    origin by several voxels). Returns the second call's launches of M1-M3,
    the .key names (in tmp) and the output files of the --all-to-all call
    ({name: bytes}, without the .key inputs and _command.txt). The hough
    stage must launch M3 twice (the scores and the inlier masks of every
    pair); one more call runs under torch.profiler for its device time."""
    import numpy as np
    import torch

    from sift3d_torch.cli import featmatch
    from sift3d_torch.io import keyfile
    from sift3d_torch.match.register import SimilarityTransform
    from sift3d_torch.pipeline.extract import extract_features

    vols, shifts = shifted_volumes(base)
    names, rows, key_ms = [], [], {"native": [], "plain": []}
    t0 = time.perf_counter()
    for i, vol in enumerate(vols):
        feats = extract_features(vol, cfg, device=dev)
        names.append(f"img{i:02d}.key")
        for route, path in (("native", os.path.join(tmp, names[-1])), ("plain", os.path.join(tmp, "plain.key.txt"))):
            t1 = time.perf_counter()
            rows.append(keyfile.write_text(feats, path, eig_threshold=cfg.eig_threshold,
                                           use_native=route == "native"))
            key_ms[route].append((time.perf_counter() - t1) * 1e3)
        if not same_bytes(os.path.join(tmp, names[-1]), os.path.join(tmp, "plain.key.txt")):
            raise AssertionError(f"{names[-1]}: the native and the plain .key writer differ")
    os.remove(os.path.join(tmp, "plain.key.txt"))
    rows = rows[::2]
    extract_s = time.perf_counter() - t0
    here = os.getcwd()
    os.chdir(tmp)
    def run(flags):
        """One featmatch call: (wall ms, [stage ms, launches] by stage,
        [translation error, |scale - 1|] of every pair, launches)."""
        before = launch_counts(MATCH)
        timer = launch_timer(MATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), timer.record():
            # the CLI's default device is the card; another device is a rehearsal's
            rc = featmatch.main([*flags, *names], timer=timer, device=None if dev.type == "cuda" else dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            raise AssertionError(f"featmatch {flags} failed: rc {rc}")
        errs = []
        for name, (dz, dy, dx) in zip(names[1:], shifts):
            ts = SimilarityTransform.read_matrix(f"{name}.trans.txt")
            errs.append([float(np.linalg.norm(ts.trans - np.array([-dx, -dy, -dz]))), abs(ts.scale - 1.0)])
        stages = {k: [round(v, 3), timer.by_stage[k]] for k, v in timer.milliseconds().items()}
        return wall, stages, np.asarray(errs, np.float64), launches_since(before)

    def outputs():
        return {f: open(f, "rb").read() for f in os.listdir(".") if f not in names and f != "_command.txt"}

    try:
        hough_wall, _, hough_errs, _ = run(["--all-to-all"])
        snapshot = outputs()
        walls = []
        for _ in range(2):
            wall, stages, errs, launches = run(["--all-to-all", "--refine"])
            walls.append(wall)
        native_files = outputs()
        # one more call with the plain .key reader and writer and match files
        native_io = (keyfile.read_text, keyfile.write_text, featmatch.write_match_file)
        keyfile.read_text = functools.partial(native_io[0], use_native=False)
        keyfile.write_text = functools.partial(native_io[1], use_native=False)
        featmatch.write_match_file = functools.partial(native_io[2], use_native=False)
        try:
            plain_wall, plain_stages, _, _ = run(["--all-to-all", "--refine"])
        finally:
            keyfile.read_text, keyfile.write_text, featmatch.write_match_file = native_io
        plain_same = outputs() == native_files
        votes = np.loadtxt("matching_votes.txt", skiprows=1, max_rows=32)
        with contextlib.redirect_stdout(io.StringIO()):
            prof = device_profile(lambda: featmatch.main(["--all-to-all", "--refine", *names],
                                                         device=None if dev.type == "cuda" else dev))
    finally:
        os.chdir(here)
    hough_launches = stages["hough"][1]
    pairs = len(names) - 1
    io_line = {
        route: {"wall": w, "read": st["read"][0], "write": st["write"][0],
                "write_key a pair": round(st["write_key"][0] / pairs, 3),
                "write_matches a pair": round(st["write_matches"][0] / pairs, 3),
                "key file write ms (median of 32)": round(statistics.median(key_ms[route]), 3)}
        for route, w, st in (("native", walls[-1], stages), ("plain", plain_wall, plain_stages))
    }
    print(f"phase10 .key I/O on {dev}: the 32 .key files byte-identical through the native and the plain writer; "
          f"--all-to-all --refine with each route (ms): {json.dumps(io_line)}; the plain call's output files "
          f"byte-identical to the native call's: {plain_same}")
    if not plain_same:
        raise AssertionError("featmatch's output files differ between the native and the plain .key I/O")
    hough_device = "not measured (no device events)" if prof is None else (
        f"{prof[6].get('hough')!r} ms of device work (M3 by name "
        f"{json.dumps({k: v for k, v in prof[4].items() if 'hough' in k})}), the call's device busy {prof[0]!r} ms")
    print(
        f"phase10 featmatch --all-to-all --refine on 32 volumes {FULL_DIMS} on {dev}: extraction + .key write "
        f"{extract_s:.2f} s, .key rows {min(rows)}..{max(rows)} ({sum(rows)} in all); wall_ms {walls!r}; "
        f"[stage ms, launches] of the second call {json.dumps(stages)}; shifts recovered: max translation "
        f"error {float(errs[:, 0].max())!r} voxel, max |scale - 1| {float(errs[:, 1].max())!r}; votes {votes.shape}, "
        f"diagonal {float(np.trace(votes))!r}, off-diagonal min {float((votes + np.eye(32) * 1e9).min())!r}; "
        f"without --refine (the winning hypothesis alone): wall_ms {hough_wall!r}, max translation error "
        f"{float(hough_errs[:, 0].max())!r} voxel (median {float(np.median(hough_errs[:, 0]))!r}), "
        f"max |scale - 1| {float(hough_errs[:, 1].max())!r}; the hough stage (every pair's Hough vote): "
        f"{stages['hough'][0]!r} ms, M3 launches {hough_launches['hough']} (the scores, then the inlier "
        f"masks), one profiled call: {hough_device}"
    )
    print(f"phase10 M2 on featmatch's .key rows: launches of the int8 route's kernel {launches['ratio_match_int8']} "
          f"({stages['ratio_match'][1]['ratio_match_int8']} in the ratio_match stage, beside "
          f"{stages['ratio_match'][1]['knn_prep_i8']} of the pre-pass), of the f32 route {launches['ratio_match_f32']}")
    # the f32 routes of M1 and M2 take no row a featmatch call makes
    if errs[:, 0].max() > 1.0 or errs[:, 1].max() > 0.05 or min(
            v for k, v in launches.items() if not k.endswith("_f32")) <= 0 or max(
            launches["knn_topk_f32"], launches["ratio_match_f32"]) > 0 or hough_launches["hough"] != 2:
        raise AssertionError(f"featmatch on the card missed a shift or a kernel: {errs.tolist()}, {launches}")
    return launches, names, snapshot


def knn_f32_entry(cfg, dev) -> int:
    """M1's f32 route has no caller in the repo that makes its rows: its
    path is the entry point match.knn.knn_search on rows that are not
    int8-range integers (here 4000 rows of seeded normal values times 20),
    which must take the f32 route, equal to the plain version. Returns its
    launches."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import knn_cuda
    from sift3d_torch.match.knn import knn_search

    rows = np.random.default_rng(11).standard_normal((4000, 64)).astype(np.float32) * 20
    x = torch.as_tensor(rows, device=dev)
    before = launch_counts(("knn_topk_f32", "knn_prep_i8", "knn_topk_int8"))
    got = knn_search(rows, rows, cfg.knn_neighbors, device=dev)
    torch.cuda.synchronize()
    got_launches = launches_since(before)
    f32, int8 = got_launches["knn_topk_f32"], got_launches["knn_prep_i8"] + got_launches["knn_topk_int8"]
    want = knn_cuda.knn_topk_plain(x, x, cfg.knn_neighbors)
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"phase10 knn_search on {rows.shape[0]} float rows (the f32 route's entry point): launches f32 {f32}, "
          f"int8 {int8}; equal to the plain version {exact}")
    if f32 != 1 or int8 != 0 or not exact:
        raise AssertionError("knn_search on float rows did not take M1's f32 route, or disagrees")
    return f32


def ratio_f32_entry(feats, cfg, dev) -> int:
    """M2's f32 route has no caller in the repo that makes its rows: its
    path is the entry point match.pairwise.ratio_match on feature sets whose
    descriptors are not int8-range integers (here the T1 features' rows plus
    seeded noise, against themselves), which must take the f32 route, equal
    to the plain version. Returns its launches."""
    import numpy as np
    import torch

    from sift3d_torch.match import pairwise

    rng = np.random.default_rng(12)
    fs = feats.select(np.arange(len(feats)))
    fs.desc = (fs.desc + rng.normal(0, 0.5, fs.desc.shape)).astype(np.float32)
    before = launch_counts(("ratio_match_f32", "knn_prep_i8", "ratio_match_int8"))
    got = pairwise.ratio_match(fs, fs, cfg, device=dev)
    torch.cuda.synchronize()
    got_launches = launches_since(before)
    f32, int8 = got_launches["ratio_match_f32"], got_launches["knn_prep_i8"] + got_launches["ratio_match_int8"]
    want = pairwise.ratio_match(fs, fs, cfg, device="cpu")
    exact = np.array_equal(got.db_idx, want.db_idx) and np.array_equal(got.ratio, want.ratio)
    print(f"phase10 ratio_match on {len(fs)} float rows (the f32 route's entry point): launches f32 {f32}, "
          f"int8 {int8}; equal to the plain version on the CPU {exact}")
    if f32 != 1 or int8 != 0 or not exact:
        raise AssertionError("ratio_match on float rows did not take M2's f32 route, or disagrees")
    return f32


FEATMATCH_FLAG_SETS = [[], ["--all-to-all"], ["-s0"], ["-s1"], ["-s2", "--all-to-all"], ["-r-"],
                       ["-n", "3", "--all-to-all"], ["-f", "list.txt", "--all-to-all"],
                       ["-g", "0.5", "--all-to-all"], ["--refine"]]


def featmatch_card_vs_cpu(tmp: str) -> None:
    """Phase 11: the featmatch CLI on the card against the CLI on the CPU,
    on the fixtures of tests/test_torch_featmatch_cli.py (two Gaussian blobs
    in 40^3, rolled by 2 along x and by -1 along y), for each flag set:
    every output file byte-identical."""
    import shutil

    import numpy as np

    from sift3d_torch.cli import featextract, featmatch
    from sift3d_torch.io import nifti

    def blob(c, s=3.0):
        z, y, x = np.mgrid[0:40, 0:40, 0:40].astype(np.float32)
        return np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s))).astype(np.float32)

    v1 = blob((20, 20, 20)) * 200 + blob((12, 26, 14), 2.5) * 150
    names = ["a.key", "b.key", "c.key"]
    keys = os.path.join(tmp, "keys")
    os.makedirs(keys)
    for name, vol in zip(names, (v1, np.roll(v1, 2, axis=2), np.roll(v1, -1, axis=1))):
        nifti.write(os.path.join(keys, "v.nii"), vol)
        with contextlib.redirect_stdout(io.StringIO()):
            featextract.main([os.path.join(keys, "v.nii"), os.path.join(keys, name)])
    here = os.getcwd()
    for flags in FEATMATCH_FLAG_SETS:
        argv = flags + ([] if "-f" in flags else names)
        dirs = {}
        for who in ("card", "cpu"):
            dirs[who] = tempfile.mkdtemp(prefix=f"{who}_", dir=tmp)
            for name in names:
                shutil.copy(os.path.join(keys, name), dirs[who])
            with open(os.path.join(dirs[who], "list.txt"), "w") as f:
                f.write("\n".join(names) + "\n")
            before = launch_counts(MATCH)
            os.chdir(dirs[who])
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = featmatch.main(argv, device=None if who == "card" else "cpu")
            finally:
                os.chdir(here)
            if who == "card":
                launches = launches_since(before)
            if rc != 0:
                raise AssertionError(f"featmatch {flags} failed on the {who}: rc {rc}")
        files = sorted(f for f in os.listdir(dirs["cpu"]) if f not in names and f != "list.txt")
        same = files == sorted(f for f in os.listdir(dirs["card"]) if f not in names and f != "list.txt")
        differ = [f for f in files if not same_bytes(os.path.join(dirs["card"], f), os.path.join(dirs["cpu"], f))]
        print(f"phase11 featmatch {' '.join(flags) or '(no flags)'}: {len(files)} output files, the same names "
              f"{same}, byte-identical card = CPU {not differ} {differ}; card launches {json.dumps(launches)}")
        want_knn = "--all-to-all" in flags
        # M3: the scores, then the inlier masks
        if not same or differ or launches["ratio_match_int8"] <= 0 or launches["hough"] < 2 or (
                want_knn and launches["knn_topk_int8"] <= 0):
            raise AssertionError(f"featmatch {flags}: the card disagrees with the CPU or ran no kernel")


BATCHES = (1, 4, 8, 16, 32)
FEATURE_FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")


def batched_runs(base, cfg):
    """Phase 12: extract_features_many on phase 10's 32 T1-grid volumes,
    the first B for B in BATCHES. Every volume's features equal
    extract_features on it alone, bit for bit; for each B the median wall
    of 5 calls after a warm-up, volumes/s, device busy ms and launch calls
    a volume and the idle share from one torch.profiler trace, the device
    peak, and the launches a batch of K7, K1, the fused K2, K3, the fused K4
    and goh (K1 once per octave, not per volume). Then a mixed batch (a
    T1-grid volume, zeros on the T1 grid, a -2- grid volume) on the card
    against the same batch on the CPU, exact. Returns the B = 4 run's
    launches, the median wall ms of each B and the features of all 32
    volumes at B = 32."""
    import torch

    from sift3d_torch.kernels.resample import subsample_2x
    from sift3d_torch.pipeline import pyramid
    from sift3d_torch.pipeline.extract import extract_features, extract_features_many

    dev = base.device
    vols, _ = shifted_volumes(base)
    singles = [extract_features(v, cfg, device=dev) for v in vols]
    n_oct = pyramid.num_octaves(tuple(base.shape), cfg)

    equal = same_features

    def call(batch, **kw):
        return extract_features_many(batch, cfg, device=dev, **kw)

    first, walls_of, results = None, {}, None
    for nb in BATCHES:
        batch = vols[:nb]
        got = call(batch)  # the warm-up, and the check
        same = [equal(g, w) for g, w in zip(got, singles)]
        before = launch_counts(EXTRACTION)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        call(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        launches = launches_since(before)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        prof = device_profile(lambda: call(batch))
        if prof is None:
            traced = "device time not measured (no device events)"
        else:
            busy, _, _, n_launch, _, per_stage, _ = prof
            traced = (f"device busy {busy!r} ms ({busy / nb!r} a volume), {n_launch} launch calls "
                      f"({n_launch / nb!r} a volume; [launch calls, stage calls] by stage "
                      f"{json.dumps(per_stage)}), idle share "
                      f"{1 - busy / wall!r} of the median wall")
        print(f"phase12 extract_features_many B {nb} on {dev}: {sum(len(g) for g in got)} features; equal to "
              f"extract_features on each volume alone {all(same)}; wall_ms {walls!r} (median {wall!r}, "
              f"{wall / nb!r} a volume, {nb / wall * 1e3!r} volumes/s); {traced}; device peak {peak} B; "
              f"launches a batch {json.dumps(launches)}")
        if not all(same) or launches["dogs_extrema"] != n_oct or min(launches.values()) <= 0:
            raise AssertionError(f"batched extraction at B {nb} differs from single-volume extraction or "
                                 f"missed a kernel: {same}, {launches}")
        if nb == 4:
            first = launches
        walls_of[nb] = wall
        if nb == max(BATCHES):
            results = got
        del got
    mixed = [vols[1], torch.zeros_like(base), subsample_2x(vols[2])]
    on_card = call(mixed)
    on_cpu = extract_features_many([v.cpu() for v in mixed], cfg, device="cpu")
    same = [equal(a, b) for a, b in zip(on_card, on_cpu)]
    print(f"phase12 mixed batch (T1 grid, zeros on the T1 grid, -2- grid) card vs CPU: features "
          f"{[len(f) for f in on_card]} / {[len(f) for f in on_cpu]}; equal bit for bit {same}")
    if not (all(same) and len(on_card[1]) == 0 and len(on_card[0]) > 0 and len(on_card[2]) > 0):
        raise AssertionError(f"batched extraction on the card disagrees with the CPU on the mixed batch: {same}")
    return first, walls_of, results


PLACEMENT_ENTRIES = 4


def same_features(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in FEATURE_FIELDS)


def placement_runs(base, cfg, walls_of, want) -> dict:
    """Phase 13, placement: extract_features_batch over PLACEMENT_ENTRIES
    entries of cuda:0 (one host thread each, 8 volumes an entry) on phase
    12's 32 volumes, and over every card when there are two or more. Each
    volume equal to phase 12's B = 32 result (want), bit for bit; the
    median wall of 5 calls after a warm-up beside phase 12's B = 8 and 32
    walls, volumes/s, the device peak over one call, and the launches of
    K7, K1, the fused K2, K3, the fused K4 and goh in one call, each > 0.
    Returns those launches (the cuda:0 mesh's)."""
    import torch

    from sift3d_torch import extract_features_batch

    dev = base.device
    vols, _ = shifted_volumes(base)
    meshes = {f"{PLACEMENT_ENTRIES} x {dev}": [dev] * PLACEMENT_ENTRIES}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = None
    first = None
    for label, mesh in meshes.items():
        got = extract_features_batch(vols, mesh, cfg)  # the warm-up, and the check
        same = [same_features(g, w) for g, w in zip(got, want)]
        before = launch_counts(EXTRACTION)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        extract_features_batch(vols, mesh, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        launches = launches_since(before)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract_features_batch(vols, mesh, cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        print(f"phase13 extract_features_batch over {label} on {len(vols)} volumes {tuple(base.shape)}: "
              f"{sum(len(g) for g in got)} features; equal to phase 12's extract_features_many bit for bit "
              f"{all(same)}; wall_ms {walls!r} (median {wall!r}, {len(vols) / wall * 1e3!r} volumes/s; phase 12 "
              f"median at B 8 {walls_of[8]!r}, at B 32 {walls_of[32]!r}); device peak on {dev} {peak} B; "
              f"launches a call {json.dumps(launches)}")
        if not all(same) or len(got) != len(want) or min(launches.values()) <= 0:
            raise AssertionError(f"placement over {label} differs from batched extraction or missed a kernel: "
                                 f"{same}, {launches}")
        first = first or launches
        del got
    return first


def sharded_knn_run(feats, cfg, dev) -> int:
    """Phase 13, the sharded kNN: sharded_knn over PLACEMENT_ENTRIES entries
    of the card on phase 2's first M1 input (the GoH rows tiled to
    MATCH_ROWS), exact against knn_search, M1 (its int8 route: the pre-pass,
    the main kernel and, for a quarter's queries, the slices' merge) once
    per entry; its median ms (CUDA events) beside one call of M1 on the
    whole input. Returns the launches of one sharded call."""
    import torch

    from sift3d_torch.dist.gather import sharded_knn
    from sift3d_torch.kernels import knn_cuda
    from sift3d_torch.match.knn import knn_search

    x = torch.as_tensor(tiled_goh_rows(feats), dtype=torch.float32, device=dev)
    k = cfg.knn_neighbors
    mesh = [dev] * PLACEMENT_ENTRIES
    want = knn_search(x, x, k, device=dev)
    chunk = -(-x.shape[0] // len(mesh))
    slices = knn_cuda.int8_plan(chunk, x.shape[0], knn_cuda.int8_places(dev, x.shape[1], k))[0]
    per_entry = 2 + (slices > 1)
    before = launch_counts(("knn_prep_i8", "knn_topk_int8"))
    got = sharded_knn(x, x, k, mesh)
    torch.cuda.synchronize()
    launches = sum(launches_since(before).values())
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sharded_ms = median_ms(lambda: sharded_knn(x, x, k, mesh))
    single_ms = median_ms(lambda: knn_cuda.knn_topk(x, x, k))
    print(f"phase13 sharded_knn over {len(mesh)} x {dev}, {x.shape[0]} x {x.shape[1]} rows, k={k}: equal to "
          f"knn_search {exact}; M1 launches {launches} ({per_entry} an entry: {chunk} queries cut the database "
          f"into {slices} slices); {sharded_ms!r} ms (median of {REPS}, CUDA events) beside one M1 call on all "
          f"rows {single_ms!r} ms")
    if not exact or launches != len(mesh) * per_entry:
        raise AssertionError(f"sharded_knn differs from knn_search or launched M1 {launches} times")
    return launches


def shard_match_run(keys_dir: str, names, snapshot, dev, tmp: str) -> None:
    """Phase 13, featmatch --all-to-all --shard-match on phase 10's .key
    files, its kNN over PLACEMENT_ENTRIES entries of the card, then over
    every card (the CLI's own mesh): every output file (but _command.txt,
    which records the flags) byte-identical to phase 10's --all-to-all
    call's; the group_vote stage's ms and launches."""
    import shutil

    from sift3d_torch.cli import featmatch

    here = os.getcwd()
    for label, mesh in ((f"{PLACEMENT_ENTRIES} x {dev}", [dev] * PLACEMENT_ENTRIES), ("every card", None)):
        work = tempfile.mkdtemp(prefix="shard_match_", dir=tmp)
        for name in names:
            shutil.copy(os.path.join(keys_dir, name), work)
        timer = launch_timer(MATCH)
        os.chdir(work)
        try:
            with contextlib.redirect_stdout(io.StringIO()), timer.record():
                # the CLI's default device is the card; another device is a rehearsal's
                rc = featmatch.main(["--all-to-all", "--shard-match", *names], timer=timer, mesh=mesh,
                                    device=None if dev.type == "cuda" else dev)
        finally:
            os.chdir(here)
        files = sorted(f for f in os.listdir(work) if f not in names and f != "_command.txt")
        differ = [f for f in files if f not in snapshot or not same_bytes_data(os.path.join(work, f), snapshot[f])]
        missing = sorted(set(snapshot) - set(files))
        stages = {k: [round(v, 3), timer.by_stage[k]] for k, v in timer.milliseconds().items()}
        print(f"phase13 featmatch --all-to-all --shard-match over {label} on phase 10's {len(names)} .key files: "
              f"rc {rc}; {len(files)} output files, byte-identical to phase 10's --all-to-all "
              f"{not differ and not missing} (differ {differ}, missing {missing}); group_vote "
              f"{timer.milliseconds().get('group_vote')!r} ms, [stage ms, launches] {json.dumps(stages)}")
        if rc != 0 or differ or missing or timer.by_stage["group_vote"]["knn_topk_int8"] <= 0:
            raise AssertionError(f"featmatch --shard-match over {label} differs from phase 10's files")


def same_bytes_data(path: str, data: bytes) -> bool:
    with open(path, "rb") as f:
        return f.read() == data


def sharded_solve_run(dev) -> None:
    """Phase 13, the weighted sharded solve: 100,000 seeded correspondences
    of a similarity with noise and weights, over 1, 3 and PLACEMENT_ENTRIES
    entries of the card, each bit-equal to the single-device solve on the
    card and to the solve on the CPU."""
    import numpy as np

    from sift3d_torch.dist.solve import solve_similarity_sharded
    from sift3d_torch.match.solve import solve_similarity

    rng = np.random.default_rng(9)
    p = rng.uniform(20, 160, (100_000, 3)).astype(np.float32)
    q = (1.1 * p @ rotation(9).T + np.array([3.0, -2.0, 5.0]) + rng.normal(0, 1.0, p.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, p.shape[0]).astype(np.float32)
    want = solve_similarity(p, q, w, device=dev)
    on_cpu = solve_similarity(p, q, w, device="cpu")

    def equal(a, b):
        return a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])

    same = {n: equal(solve_similarity_sharded(p, q, w, [dev] * n), want) for n in (1, 3, PLACEMENT_ENTRIES)}
    print(f"phase13 solve_similarity_sharded on {p.shape[0]} weighted correspondences: bit-equal to the "
          f"single-device solve over [1, 3, {PLACEMENT_ENTRIES}] entries of {dev} {json.dumps(same)}; card = CPU "
          f"{equal(want, on_cpu)}; scale {want[0]!r}")
    if not all(same.values()) or not equal(want, on_cpu):
        raise AssertionError(f"the sharded solve differs from the single-device solve: {same}")


def multiprocess_run(base, cfg, want, tmp: str) -> None:
    """Phase 13, two processes: scripts/torch_multihost_worker.py twice, both
    on cuda:0, in one gloo process group (a file:// store in tmp), on the
    first 4 of phase 12's volumes. Each rank's gathered sets equal phase
    12's results bit for bit, and its rank-spanning group vote, sharded kNN
    and solve equal this process's single-process calls; each rank's
    extraction ms of its share and the exchange's ms (host clock after a
    barrier) and bytes."""
    import subprocess

    import numpy as np
    import torch

    from sift3d_torch.match.groupvote import GroupMatcher
    from sift3d_torch.match.knn import knn_search
    from sift3d_torch.match.solve import solve_similarity

    vols, _ = shifted_volumes(base, 4)
    torch.cuda.empty_cache()  # the workers share the card with this process's cached blocks
    np.save(os.path.join(tmp, "vols.npy"), np.stack([v.cpu().numpy() for v in vols]))
    worker = os.path.join(HERE, "scripts", "torch_multihost_worker.py")
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
    init = "file://" + os.path.join(tmp, "pg")
    procs = [subprocess.Popen([sys.executable, worker, init, str(r), "2", os.path.join(tmp, "vols.npy"), outs[r],
                               "--device", str(base.device)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            pr.kill()
            pr.wait()
    for r, pr in enumerate(procs):
        if pr.returncode != 0:
            raise AssertionError(f"multi-process rank {r} failed (rc {pr.returncode}):\n{logs[r][-4000:]}")
    sets = want[:4]
    vote = GroupMatcher(sets, device=base.device).match_all_to_all()
    db = np.concatenate([s.desc for s in sets])
    kd, ki = (t.cpu().numpy() for t in knn_search(db, db, 5, device=base.device))
    checks = []
    for r, path in enumerate(outs):
        out = dict(np.load(path))
        got = [all(np.array_equal(out[f"set{i}_{k}"], getattr(s, k)) for k in FEATURE_FIELDS)
               for i, s in enumerate(sets)]
        solve = solve_similarity(out["p"], out["q"], out["w"], device=base.device)
        ok = {
            "sets": all(got) and int(out["n_sets"]) == len(sets),
            "vote": bool(np.array_equal(out["votes"], vote.votes) and np.array_equal(out["counts"], vote.counts)
                         and np.array_equal(out["log_likelihood"], vote.log_likelihood)),
            "knn": bool(np.array_equal(out["knn_dist"], kd) and np.array_equal(out["knn_idx"], ki)),
            "solve": bool(float(out["scale"]) == solve[0] and np.array_equal(out["trans"], solve[2])),
            "ownership errors": all(e.startswith("volume 0: expected exactly one owning process")
                                    for e in out["errors"].tolist()),
        }
        checks.append(ok)
        print(f"phase13 two processes (gloo) on {base.device}, rank {r} of 2, volumes {out['mine'].tolist()} of 4: "
              f"extraction {float(out['extract_ms'])!r} ms (its share, after a warm-up); "
              f"exchange {float(out['exchange_ms'])!r} ms for {int(out['exchange_bytes'])} B of [rows, 84] f32 "
              f"tables ({sum(len(s) for s in sets)} rows); equal to the single-process results {json.dumps(ok)}")
    if not all(all(ok.values()) for ok in checks):
        raise AssertionError(f"the two-process run differs from the single-process results: {checks}")


# profiler names of the kernels whose wrapper is named otherwise
TRACE_NAMES = {"blur3d": ("::blur",), "gather_eig": ("::identity_eig_kernel",), "canonical": ("::canonical_",),
               "rotated_goh": ("::goh_kernel<true>",), "goh": ("::goh_kernel<false>",)}


def sample_rotated_entry(vol, feats, cfg) -> int:
    """K4's patch mode has no caller on a path since the BRIEF path is fused:
    its path is its entry point patch_cuda.sample_rotated, here on the T1
    octave-0 stack at the extraction's reoriented rows (levels 1-3 in turn).
    Returns its launches."""
    import numpy as np
    import torch

    from sift3d_torch.kernels import patch_cuda

    gstack = dogs_stack_rows(vol, cfg)[0]
    sel = np.nonzero(feats.is_reoriented)[0]
    dev = gstack.device
    lvl = torch.as_tensor(sel % 3 + 1, dtype=torch.int32, device=dev)
    rows = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
            for a in (feats.xyz[sel], feats.scale[sel], feats.ori[sel])]
    before = launch_counts(("sample_rotated",))
    patches = patch_cuda.sample_rotated(gstack, lvl, *rows)
    torch.cuda.synchronize()
    n = launches_since(before)["sample_rotated"]
    ok = bool(torch.isfinite(patches).all())
    print(f"phase3 K4's patch mode entry point (sample_rotated) on {len(sel)} reoriented T1 rows: patches "
          f"{tuple(patches.shape)}, finite {ok}; launches {n}")
    if n != 1 or not ok:
        raise AssertionError("K4's patch mode did not run through its entry point")
    return n


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sift3d_torch.cli import featextract
    from sift3d_torch.core.config import DEFAULT_CONFIG as cfg
    from sift3d_torch.core.device import resolve_device
    from sift3d_torch.io import keyfile, native, nifti
    from sift3d_torch.kernels import cuda_lib, hist_cuda
    from sift3d_torch.pipeline import features
    from sift3d_torch.pipeline.extract import extract_features
    from sift3d_torch.utils.synthetic import (
        repeatability, synthetic_blob_texture, synthetic_volume,
    )
    from sift3d_torch.utils.timing import TRACER

    card = card_line()
    dev = resolve_device("cuda:0")
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    print(
        f"phase1 card {card}; torch {torch.__version__}; cuda {torch.version.cuda}; "
        f"kernel build {build_s:.1f} s ({cuda_lib.library_path().parent.name}); native .key I/O "
        f"(csrc/key_text.cpp): g++ build {native.build_seconds()!r} s, loaded in {native_s:.3f} s "
        f"({native.library_path().parent.name})"
    )
    redesigned = nvcc_report(("blur", "hist_topk", "canonical_", "splat_histogram_raw",
                              "smooth_histogram_peaks", "dogs_extrema", "extrema_mask", "identity_eig",
                              "goh_kernel", "brief_kernel",
                              "knn_", "ratio_", "hough_kernel", "double_size", "isotropic_resample"))
    print(f"phase1 nvcc.log, [registers, shared B, spill store B, spill load B] of K7, K3, K8, K9, "
          f"the fused canonical stage (canonical_primary_kernel, canonical_secondary_kernel), "
          f"K1, K6, the fused K2 (identity_eig_kernel), the fused K4 (goh_kernel<1> sampling, "
          f"<0> on given patches; brief_kernel<R, 1> sampling, <R, 0> on given patches, R the pre-blur's "
          f"radius), M1 (its int8 route: knn_prep_kernel<C>, knn_topk_i8_kernel<C, KM>, "
          f"knn_merge_kernel<KM>; its f32 route: knn_topk_kernel<C, KM>), M2 (its int8 route: "
          f"ratio_i8_kernel<1> with the geometry in shared memory, <0> without; its f32 route: "
          f"ratio_match_kernel), M3 (hough_kernel, both modes), K10 (double_size_kernel) and K11 "
          f"(isotropic_resample_kernel): "
          f"{json.dumps(redesigned)}")
    for kernel, what in (("knn_topk_i8_kernel", "M1's int8 kernels"), ("ratio_i8_kernel", "M2's int8 kernels")):
        imma = sass_count(kernel, "IMMA")
        print(f"phase1 cuobjdump -sass: int8 tensor-core instructions (IMMA) in {what} {json.dumps(imma)}")
        if not imma or min(imma.values()) <= 0:
            raise AssertionError(f"{what} hold no IMMA instruction: {imma}")
    spills = sorted(k for k, v in nvcc_report(("",)).items() if v[2] or v[3])
    if spills:
        print(f"phase1 warning: kernels that spill registers: {spills}")

    vol_np = synthetic_blob_texture(FULL_DIMS, seed=7)
    vol = torch.from_numpy(vol_np).to(dev)
    kernels = compare_kernels(vol, cfg)
    kernels += compare_batched(vol, cfg)
    kernels += compare_matching(extract_features(vol, cfg, device=dev), cfg, dev)

    extract_features(vol, cfg, device=dev)  # warm-up (cuBLAS handles, caches)
    before = launch_counts(EXTRACTION)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TRACER.record(dev):
        feats = extract_features(vol, cfg, device=dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launches_since(before)
    n_reor = int(feats.is_reoriented.sum())
    # [host ms, stream ms] of each span (the tracer waits for nothing)
    totals = TRACER.totals()
    stages = {k: [round(t.host_ms, 3), round(t.stream_ms, 3)] for k, t in totals.items()}
    counts = {k: TRACER.counts.get(k) for k in ("canonical_rows", "reoriented_rows")}
    print(
        f"phase3 extract_features {FULL_DIMS} on {dev}: {len(feats)} features "
        f"({len(feats) - n_reor} unoriented, {n_reor} reoriented); wall {wall_ms!r} ms; "
        f"spans [host ms, stream ms] {json.dumps(stages)}; launches {json.dumps(launches)}; "
        f"counters {json.dumps(counts)}"
    )
    if len(feats) == 0 or min(launches.values()) <= 0:
        raise AssertionError(f"main path did not run every kernel: {launches}, {len(feats)} features")
    if (launches["canonical"] != totals["canonical"].calls
            or counts != {"canonical_rows": len(feats) - n_reor, "reoriented_rows": n_reor}):
        raise AssertionError(f"the fused canonical stage ran {launches['canonical']} times in "
                             f"{totals['canonical'].calls} canonical spans; counters {counts}")
    finite = all(np.isfinite(a).all() for a in (feats.xyz, feats.scale, feats.ori, feats.eigs))
    ranks_ok = bool((np.sort(feats.desc, axis=1) == np.arange(64)).all())
    if not (finite and ranks_ok):
        raise AssertionError(f"bad features: finite={finite}, descriptors are ranks={ranks_ok}")
    # K3 (whose body the fused canonical stage runs), K8 and K9 have no
    # caller on the main path (K8 and K9 none in the JAX package either):
    # their own path is their entry points, here on T1's primary histograms
    _, _, in_bounds, pn, _, _, eig_keep = features.gather_eig(
        *dogs_stack_rows(vol, cfg), tuple(cfg.level_sigmas()), cfg
    )
    e3, wgt = features.sphere_edges(pn[in_bounds & eig_keep])
    centred = [u + 0.5 for u in features.splat_coords(e3)]  # the JAX functions' 0.5 centres
    band = features.ori_hist_band(cfg, dev)
    before = launch_counts(("hist_topk", "splat_histogram_raw", "smooth_histogram_peaks", "blur3d"))
    tops = hist_cuda.hist_topk(*features.splat_coords(e3), wgt, band, cfg.max_primary_orientations)
    smoothed = hist_cuda.smooth_histogram(*centred, wgt, cfg.ori_hist_blur_sigma)
    hb, pk = hist_cuda.smooth_histogram_peaks(*centred, wgt, band)
    torch.cuda.synchronize()
    entry_launches = launches_since(before)
    fin = bool(torch.isfinite(smoothed).all() and torch.isfinite(hb).all()
               and torch.equal(torch.isfinite(pk), pk > -torch.inf) and torch.isfinite(tops[:, 0, 0]).any())
    print(
        f"phase3 K3/K8/K9 entry points on {wgt.shape[0]} T1 octave-0 primary histograms "
        f"(V={wgt.shape[1]}): hist_topk {tuple(tops.shape)}, smooth_histogram {tuple(smoothed.shape)}, "
        f"smooth_histogram_peaks "
        f"{int(torch.isfinite(pk).sum())} peaks; finite {fin}; launches {json.dumps(entry_launches)}"
    )
    if not fin or min(entry_launches.values()) <= 0:
        raise AssertionError(f"the K3/K8/K9 entry points did not run their kernels: {entry_launches}")
    launches.update({k: entry_launches[k] for k in ("hist_topk", "splat_histogram_raw",
                                                     "smooth_histogram_peaks")})
    del pn, e3, wgt, centred, smoothed, hb, pk, tops
    launches["sample_rotated"] = sample_rotated_entry(vol, feats, cfg)

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_features(vol, cfg, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    prof = device_profile(lambda: extract_features(vol, cfg, device=dev))
    if prof is None:
        print(f"phase4 wall_ms {walls!r} (median {wall!r}); device time not measured (no device events)")
    else:
        busy, span, n_dev, n_launch, per_name, per_stage, _ = prof
        ours = {}
        for name in EXTRACTION:
            # K7 launches blur_xy_kernel and blur_col_kernel, or blur3d_small_kernel
            hits = [v for k, v in per_name.items() if any(tag in k for tag in TRACE_NAMES.get(name, (f"::{name}_kernel",)))]
            ours[name] = [sum(n for n, _ in hits), round(sum(ms for _, ms in hits), 4)]
        stage_launches = per_stage
        top = {name: [n, round(ms, 4)] for name, (n, ms) in list(per_name.items())[:10]}
        k7 = {}  # K7's kernels by template instance
        for k, (n, ms) in per_name.items():
            m = re.search(r"::(blur\w+<[^>]*>)", k)
            if m:
                n0, ms0 = k7.get(m.group(1), (0, 0.0))
                k7[m.group(1)] = [n0 + n, round(ms0 + ms, 4)]
        canonical_calls = stage_launches.get("canonical", [0, 0])
        if not 0 < canonical_calls[0] <= CANONICAL_LAUNCHES * canonical_calls[1]:
            raise AssertionError(f"the canonical stage made {canonical_calls[0]} launch calls in "
                                 f"{canonical_calls[1]} calls (at most {CANONICAL_LAUNCHES} a call)")
        print(
            f"phase4 wall_ms {walls!r} (median {wall!r}); profiled: device busy {busy!r} ms in "
            f"{n_dev} device events, {n_launch} launch calls ([launch calls, stage calls] by stage "
            f"{json.dumps(stage_launches)}), trace span {span!r} ms; idle share "
            f"{1 - busy / wall!r} of the unprofiled median wall, {1 - busy / span!r} of the span; "
            f"device [events, ms] of the port's kernels {json.dumps(ours)} (K7 by kernel "
            f"{json.dumps(k7)}), of the "
            f"{len(top)} costliest of {len(per_name)} kernel names {json.dumps(top)}"
        )

    small = synthetic_volume(64)
    on_gpu = extract_features(small, cfg, device=dev)
    on_cpu = extract_features(small, cfg, device="cpu")
    rep_gc, _ = repeatability(on_gpu, on_cpu)
    rep_cg, _ = repeatability(on_cpu, on_gpu)
    same = len(on_gpu) == len(on_cpu)
    desc_eq = float((on_gpu.desc == on_cpu.desc).all(axis=1).mean()) if same and len(on_gpu) else 0.0
    diffs = {k: float(np.abs(getattr(on_gpu, k) - getattr(on_cpu, k)).max()) if same and len(on_gpu)
             else float("inf") for k in ("xyz", "scale", "ori", "eigs")}
    print(
        f"phase5 card vs cpu on synthetic_volume(64): counts {len(on_gpu)} / {len(on_cpu)}; "
        f"repeatability {rep_gc!r} / {rep_cg!r}; identical descriptors {desc_eq!r}; "
        f"max diff {json.dumps(diffs)} (exact)"
    )
    if not (same and len(on_gpu) > 0 and rep_gc == 1.0 and rep_cg == 1.0 and desc_eq == 1.0
            and max(diffs.values()) == 0.0):
        raise AssertionError("the port on the card disagrees with the port on the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        nii = os.path.join(tmp, "v.nii")
        nifti.write(nii, small)
        before = launch_counts(EXTRACTION)
        with contextlib.redirect_stdout(io.StringIO()):
            rc_card = featextract.main([nii, os.path.join(tmp, "card.key")])
            cli_launches = launches_since(before)
            rc_cpu = featextract.main([nii, os.path.join(tmp, "cpu.key")], device="cpu")
        card_key, cpu_key = (keyfile.read_text(os.path.join(tmp, f))[0] for f in ("card.key", "cpu.key"))
        with open(os.path.join(tmp, "card.key")) as a, open(os.path.join(tmp, "cpu.key")) as b:
            lines_differ = sum(x != y for x, y in zip(a, b))
        key_eq = same_bytes(os.path.join(tmp, "card.key"), os.path.join(tmp, "cpu.key"))
    same = len(card_key) == len(cpu_key)
    geo_eq = same and bool((card_key.xyz == cpu_key.xyz).all() and (card_key.scale == cpu_key.scale).all())
    desc_eq = same and bool((card_key.desc == cpu_key.desc).all())
    d_ori = float(np.abs(card_key.ori - cpu_key.ori).max()) if same and len(card_key) else float("inf")
    d_eig = float(np.abs(card_key.eigs - cpu_key.eigs).max()) if same and len(card_key) else float("inf")
    print(
        f"phase6 CLI (no flags) on {dev}: rc {rc_card}, {len(card_key)} .key rows, launches "
        f"{json.dumps(cli_launches)}; CLI on the CPU: rc {rc_cpu}, {len(cpu_key)} rows; "
        f"{lines_differ} lines differ, .key files byte-identical {key_eq}; equal locations and scales "
        f"{geo_eq}, descriptors {desc_eq}; max orientation diff {d_ori!r}, max eigenvalue diff {d_eig!r}"
    )
    if not (rc_card == 0 and rc_cpu == 0 and min(cli_launches.values()) > 0 and key_eq):
        raise AssertionError("the CLI did not run the kernels on the card, or disagrees with the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        rows_of, launches_of = cli_full_width(
            vol_np, EXTRACTION + ("rotated_brief", "brief", "double_size_batch", "isotropic_resample_batch",
                                  "sample_rotated"), tmp)
    # the fused BRIEF kernels run on the BRIEF path only: their launches are
    # -bn's; K10 runs on -2+ alone, K11 on -w and -ws alone
    launches.update(rotated_brief=launches_of["-bn"]["rotated_brief"], brief=launches_of["-bn"]["brief"],
                    double_size_batch=launches_of["-2+"]["double_size_batch"],
                    isotropic_resample_batch=launches_of["-w"]["isotropic_resample_batch"])
    with tempfile.TemporaryDirectory() as tmp:
        cli_card_vs_cpu(EXTRACTION, tmp)
    launches["extrema_mask"] = spatial_runs(vol, cfg, rows_of["-2+"])["extrema_mask"]
    with tempfile.TemporaryDirectory() as keys_dir:  # phase 10's .key files, read again by phase 13
        match_launches, key_names, snapshot = featmatch_full_width(vol, cfg, dev, keys_dir)
        launches.update(match_launches)
        # M3's scores and inlier masks are one entry's two modes
        launches.update(hough_scores=match_launches["hough"], hough_inliers=match_launches["hough"])
        launches["knn_topk_f32"] = knn_f32_entry(cfg, dev)
        launches["ratio_match_f32"] = ratio_f32_entry(feats, cfg, dev)
        with tempfile.TemporaryDirectory() as tmp:
            featmatch_card_vs_cpu(tmp)
        # the batched rows' launches are phase 12's at B = 4
        batched, walls_of, many = batched_runs(vol, cfg)
        launches.update(dogs_extrema_batch=batched["dogs_extrema"], gather_eig_union=batched["gather_eig"],
                        rotated_goh_union=batched["rotated_goh"])
        # phase 13: the multi-card layer (dist/) placed over entries of the card
        placement_runs(vol, cfg, walls_of, many)
        sharded_knn_run(feats, cfg, dev)
        with tempfile.TemporaryDirectory() as tmp:
            shard_match_run(keys_dir, key_names, snapshot, dev, tmp)
        sharded_solve_run(dev)
        with tempfile.TemporaryDirectory() as tmp:
            multiprocess_run(vol, cfg, many, tmp)
        del many, snapshot

    for k in kernels:
        k["launches"] = launches[k["name"]]
    table = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}
        for k in kernels
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
