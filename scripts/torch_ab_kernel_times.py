"""Time the single-volume main-path kernels of two checkouts on one CUDA card.

    python scripts/torch_ab_kernel_times.py OTHER_CHECKOUT

Runs four processes in turns, OTHER, this, this, OTHER, each importing
sift3d_torch from its own checkout (which builds its own kernels into its
own _build/). Each times, back to back (a call's share of a burst of 20,
median of 5 bursts, CUDA events), on the octave-0 Gaussian stack and rows
of the 182x218x182 blob texture: K1 (dogs_extrema), the fused K2
(gather_eig, its candidates tiled to 4096 rows) and the fused K4
(rotated_goh, the reoriented rows tiled to 4096). Only the single-volume
calls every checkout of the port has are used. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from sift3d_torch.core.config import DEFAULT_CONFIG as cfg
    from sift3d_torch.kernels import extrema_cuda, patch_cuda
    from sift3d_torch.pipeline import features, pyramid
    from sift3d_torch.utils.synthetic import synthetic_blob_texture

    def burst(fn, n=20, reps=5):
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

    def tiled(rows, n=4096):
        reps = -(-n // rows[0].shape[0])
        return [torch.cat([t] * reps).contiguous() for t in rows]

    dev = torch.device("cuda:0")
    vol = torch.from_numpy(synthetic_blob_texture((182, 218, 182), seed=7)).to(dev)
    gstack, _, _, _ = pyramid.octave_core(pyramid.initial_blur_core(vol, cfg), cfg)
    gstack = gstack.contiguous()
    dogs, mask = extrema_cuda.dogs_extrema(gstack)
    lvl, zyx, _ = features.candidate_table(mask)
    sig = tuple(cfg.level_sigmas())
    crows = tiled([lvl, zyx.contiguous()])
    xyz, scale, in_bounds, pn, _, _, keep = features.gather_eig(gstack, dogs, lvl, zyx, sig, cfg)
    kidx = torch.nonzero(in_bounds & keep)[:, 0]
    o = features.canonical_stage(pn[kidx], cfg)
    row, slot = features.reoriented_slots(o["ori_valid"], cfg)
    s = cfg.max_primary_orientations * cfg.max_secondary_orientations
    rrows = tiled([lvl.to(torch.int32)[kidx][row], xyz[kidx][row], scale[kidx][row],
                   o["ori"].reshape(-1, s, 3, 3)[row, slot]])
    return {
        "dogs_extrema": burst(lambda: extrema_cuda.dogs_extrema(gstack)),
        "gather_eig": burst(lambda: features.gather_eig(gstack, dogs, *crows, sig, cfg)),
        "rotated_goh": burst(lambda: patch_cuda.rotated_goh(gstack, *rrows)),
    }


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", other if who == "other" else HERE],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        runs[who].append(json.loads(out.strip().splitlines()[-1]))
    print(json.dumps({"card": card, "other": other, "back_to_back_ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
