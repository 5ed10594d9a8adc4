#!/usr/bin/env python3
"""Drive the PyTorch port (sift3d_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card (nvidia-smi name and power limit), PyTorch and CUDA versions,
     and the seconds the hand-written kernels took to build (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at main-path shapes — K1 on the full-size octave-0 Gaussian stack, K2,
     K3 and K4 on the rows the full-size run produces in octave 0 — with the
     max abs difference, the tolerance, and median milliseconds of both;
  3. extract_features on the 182x218x182 blob texture (the 1 mm MNI T1
     grid) on cuda:0: per-stage milliseconds, feature counts, and every
     kernel's launch count in that run (each must be > 0);
  4. the same call without the timer (host wall of five calls) and once
     under torch.profiler: device busy milliseconds, the trace's span, and
     the idle share against both (the profiler slows the host, so the
     share against the unprofiled wall is the one a user sees);
  5. the port on the card against the port on the CPU on
     synthetic_volume(64): equal counts, repeatability 1.0 both ways,
     identical descriptors on >= 99% of rows;
  6. the CLI with no flags (it runs on cuda:0) on that volume as NIfTI,
     against the CLI on the CPU: every kernel launched, equal .key rows,
     locations, scales and descriptors (orientations may differ: the
     patch normalization and the structure tensor are reductions that sum
     in another order on the card, and an eigenvector of a nearly
     degenerate tensor amplifies the last-bit difference).
Then the kernel table as one JSON line, the card line, and last the
result line. Any failure raises and exits non-zero; without a CUDA card,
or without the sift3d_torch package beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FULL_DIMS = (182, 218, 182)
MIN_ROWS = 4096
REPS = 10


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


def at_least(rows, n: int):
    """Row tensors tiled up to >= n rows (timing at a realistic row count)."""
    import torch

    reps = -(-n // rows[0].shape[0])
    return [torch.cat([t] * reps).contiguous() for t in rows]


def max_abs(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(a[~both], b[~both]):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def device_profile(fn):
    """Run fn() once under torch.profiler; returns (device busy ms, span ms
    from the first device event's start to the last one's end, device
    events, runtime launch calls), or None when the trace holds no device
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    launch_names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
    return busy, span, len(dev), sum(1 for e in events if e.name in launch_names)


def compare_kernels(vol, cfg):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

    from sift3d_torch.kernels import extrema_cuda, hist_cuda, patch_cuda
    from sift3d_torch.kernels.gauss import blur3d
    from sift3d_torch.pipeline import features, pyramid

    results = []

    def record(name, source, replaces, kernel, plain, tol, note):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs(g.float(), w.float()) for g, w in zip(got, want))
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        print(
            f"phase2 {name}: {note}; max_abs_err {err!r} (tolerance {tol!r}); "
            f"kernel {ms!r} ms, plain {plain_ms!r} ms"
        )
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
        results.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    base = pyramid.initial_blur_core(vol, cfg)
    inc = cfg.incremental_sigmas()
    levels = [base]
    for j in range(1, cfg.blurs_total):
        levels.append(blur3d(levels[-1], inc[j - 1], cfg.blur_precision))
    gstack = torch.stack(levels).contiguous()
    record(
        "dogs_extrema", "sift3d_torch/csrc/dogs_extrema.cu", "sift3d/kernels/extrema_pallas.py:284",
        lambda: extrema_cuda.dogs_extrema(gstack), lambda: extrema_cuda.dogs_extrema_plain(gstack),
        0.0, f"octave-0 gstack {tuple(gstack.shape)} (exact)",
    )
    dogs, mask = extrema_cuda.dogs_extrema(gstack)

    # octave-0 rows of the main path
    lvl, zyx, _ = features.candidate_table(mask)
    xyz, scale, in_bounds, patches = features.gather_stage(
        gstack, dogs, lvl, zyx, tuple(cfg.level_sigmas())
    )
    lvl32 = lvl.to(torch.int32)
    rows = at_least([lvl32, xyz, scale], MIN_ROWS)
    peak = float(gstack.abs().max())
    record(
        "sample_identity", "sift3d_torch/csrc/sample_identity.cu", "sift3d/kernels/patch.py:375",
        lambda: patch_cuda.sample_identity(gstack, *rows),
        lambda: patch_cuda.sample_identity_plain(gstack, *rows),
        1e-5 * peak, f"{lvl.shape[0]} octave-0 candidates tiled to {rows[0].shape[0]} rows",
    )

    pn, _, _, eig_keep = features.eig_stage(patches, cfg)
    kidx = torch.nonzero(in_bounds & eig_keep)[:, 0]
    e3, wgt = features.sphere_edges(pn[kidx])
    band = features.ori_hist_band(cfg, vol.device)
    hx, hy, hz = features.splat_coords(e3)
    hrows = at_least([hx, hy, hz, wgt], MIN_ROWS)
    k1 = cfg.max_primary_orientations
    record(
        "hist_topk", "sift3d_torch/csrc/hist_topk.cu", "sift3d/kernels/hist_pallas.py:368",
        lambda: hist_cuda.hist_topk(*hrows, band, k1),
        lambda: hist_cuda.hist_topk_plain(*hrows, band, k1),
        1e-5 * float(wgt.sum(dim=1).max()),
        f"{kidx.shape[0]} octave-0 primary histograms tiled to {hrows[0].shape[0]} rows, "
        f"V={hx.shape[1]}, k={k1}",
    )

    o = features.canonical_stage(pn[kidx], cfg)
    row, slot = features.reoriented_slots(o["ori_valid"], cfg)
    s = cfg.max_primary_orientations * cfg.max_secondary_orientations
    ori_r = o["ori"].reshape(-1, s, 3, 3)[row, slot]
    rrows = at_least(
        [lvl32[kidx][row], xyz[kidx][row], scale[kidx][row], ori_r], MIN_ROWS
    )
    record(
        "sample_rotated", "sift3d_torch/csrc/sample_rotated.cu", "sift3d/kernels/patch.py:889",
        lambda: patch_cuda.sample_rotated(gstack, *rrows),
        lambda: patch_cuda.sample_rotated_plain(gstack, *rrows),
        1e-5 * peak, f"{row.shape[0]} octave-0 reoriented rows tiled to {rrows[0].shape[0]} rows",
    )
    return results


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
    from sift3d_torch.io import keyfile, nifti
    from sift3d_torch.kernels import cuda_lib, extrema_cuda, hist_cuda, patch_cuda
    from sift3d_torch.pipeline.extract import extract_features
    from sift3d_torch.utils.synthetic import (
        repeatability, synthetic_blob_texture, synthetic_volume,
    )
    from sift3d_torch.utils.timing import StageTimer

    card = card_line()
    dev = resolve_device("cuda:0")
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    print(
        f"phase1 card {card}; torch {torch.__version__}; cuda {torch.version.cuda}; "
        f"kernel build {build_s:.1f} s ({cuda_lib.library_path().parent.name})"
    )

    vol_np = synthetic_blob_texture(FULL_DIMS, seed=7)
    vol = torch.from_numpy(vol_np).to(dev)
    kernels = compare_kernels(vol, cfg)

    wrappers = {
        "dogs_extrema": extrema_cuda.dogs_extrema,
        "sample_identity": patch_cuda.sample_identity,
        "hist_topk": hist_cuda.hist_topk,
        "sample_rotated": patch_cuda.sample_rotated,
    }
    extract_features(vol, cfg, device=dev)  # warm-up (cuBLAS handles, caches)
    timer = StageTimer(enabled=True)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract_features(vol, cfg, device=dev, timer=timer)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: w.launches for name, w in wrappers.items()}
    n_reor = int(feats.is_reoriented.sum())
    stages = {k: round(v, 3) for k, v in timer.milliseconds().items()}
    print(
        f"phase3 extract_features {FULL_DIMS} on {dev}: {len(feats)} features "
        f"({len(feats) - n_reor} unoriented, {n_reor} reoriented); wall {wall_ms!r} ms; "
        f"stages_ms {json.dumps(stages)}; launches {json.dumps(launches)}"
    )
    if len(feats) == 0 or min(launches.values()) <= 0:
        raise AssertionError(f"main path did not run every kernel: {launches}, {len(feats)} features")
    finite = all(np.isfinite(a).all() for a in (feats.xyz, feats.scale, feats.ori, feats.eigs))
    ranks_ok = bool((np.sort(feats.desc, axis=1) == np.arange(64)).all())
    if not (finite and ranks_ok):
        raise AssertionError(f"bad features: finite={finite}, descriptors are ranks={ranks_ok}")
    for k in kernels:
        k["launches"] = launches[k["name"]]

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
        busy, span, n_dev, n_launch = prof
        print(
            f"phase4 wall_ms {walls!r} (median {wall!r}); profiled: device busy {busy!r} ms in "
            f"{n_dev} device events, {n_launch} launch calls, trace span {span!r} ms; idle share "
            f"{1 - busy / wall!r} of the unprofiled median wall, {1 - busy / span!r} of the span"
        )

    small = synthetic_volume(64)
    on_gpu = extract_features(small, cfg, device=dev)
    on_cpu = extract_features(small, cfg, device="cpu")
    rep_gc, _ = repeatability(on_gpu, on_cpu)
    rep_cg, _ = repeatability(on_cpu, on_gpu)
    same = len(on_gpu) == len(on_cpu)
    desc_eq = float((on_gpu.desc == on_cpu.desc).all(axis=1).mean()) if same and len(on_gpu) else 0.0
    geo = float(np.abs(on_gpu.xyz - on_cpu.xyz).max()) if same and len(on_gpu) else float("inf")
    print(
        f"phase5 card vs cpu on synthetic_volume(64): counts {len(on_gpu)} / {len(on_cpu)}; "
        f"repeatability {rep_gc!r} / {rep_cg!r}; identical descriptors {desc_eq!r}; "
        f"max xyz diff {geo!r}"
    )
    if not (same and len(on_gpu) > 0 and rep_gc == 1.0 and rep_cg == 1.0 and desc_eq >= 0.99):
        raise AssertionError("the port on the card disagrees with the port on the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        nii = os.path.join(tmp, "v.nii")
        nifti.write(nii, small)
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc_card = featextract.main([nii, os.path.join(tmp, "card.key")])
            cli_launches = {name: w.launches for name, w in wrappers.items()}
            rc_cpu = featextract.main([nii, os.path.join(tmp, "cpu.key")], device="cpu")
        card_key, cpu_key = (keyfile.read_text(os.path.join(tmp, f))[0] for f in ("card.key", "cpu.key"))
        with open(os.path.join(tmp, "card.key")) as a, open(os.path.join(tmp, "cpu.key")) as b:
            lines_differ = sum(x != y for x, y in zip(a, b))
    same = len(card_key) == len(cpu_key)
    geo_eq = same and bool((card_key.xyz == cpu_key.xyz).all() and (card_key.scale == cpu_key.scale).all())
    desc_eq = same and bool((card_key.desc == cpu_key.desc).all())
    d_ori = float(np.abs(card_key.ori - cpu_key.ori).max()) if same and len(card_key) else float("inf")
    d_eig = float(np.abs(card_key.eigs - cpu_key.eigs).max()) if same and len(card_key) else float("inf")
    print(
        f"phase6 CLI (no flags) on {dev}: rc {rc_card}, {len(card_key)} .key rows, launches "
        f"{json.dumps(cli_launches)}; CLI on the CPU: rc {rc_cpu}, {len(cpu_key)} rows; "
        f"{lines_differ} lines differ; equal locations and scales {geo_eq}, descriptors {desc_eq}; "
        f"max orientation diff {d_ori!r}, max eigenvalue diff {d_eig!r}"
    )
    if not (rc_card == 0 and rc_cpu == 0 and min(cli_launches.values()) > 0 and geo_eq and desc_eq):
        raise AssertionError("the CLI did not run the kernels on the card, or disagrees with the CPU")

    table = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                 "max_abs_err", "ms", "plain_ms")}
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
