#!/usr/bin/env python3
"""How placement's host threads share one card (sift3d_torch.dist.batch).

    python3 scripts/torch_placement_threads.py

On chip_smoke.py's 32 T1-grid volumes (phase 10's), on cuda:0: the median
wall (host clock, ending in a device sync; 5 calls after a warm-up) of
extract_features_batch over 1, 2 and 4 entries of cuda:0, each at the
interpreter's default thread switch interval and at 0.1 ms (set with
sys.setswitchinterval around the calls only), beside one
extract_features_many call on all 32 volumes and four such calls on 8
volumes in turn on one thread. Prints the card line (nvidia-smi name and
power limit) and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CALLS = 5
SHORT_INTERVAL = 1e-4


def median_wall_ms(fn) -> float:
    import torch

    fn()
    walls = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import FULL_DIMS, shifted_volumes
    from sift3d_torch import extract_features_batch, extract_features_many
    from sift3d_torch.utils.synthetic import synthetic_blob_texture

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    vols, _ = shifted_volumes(torch.from_numpy(synthetic_blob_texture(FULL_DIMS, seed=7)).to(dev))
    default = sys.getswitchinterval()
    out = {"card": card, "volumes": len(vols), "calls": CALLS, "default_switch_interval_s": default,
           "many_32_ms": median_wall_ms(lambda: extract_features_many(vols, device=dev)),
           "many_4x8_in_turn_ms": median_wall_ms(
               lambda: [extract_features_many(vols[i::4], device=dev) for i in range(4)])}
    for entries in (1, 2, 4):
        for label, interval in (("default", default), ("0.1ms", SHORT_INTERVAL)):
            sys.setswitchinterval(interval)
            try:
                out[f"placement_{entries}x_{label}_ms"] = median_wall_ms(
                    lambda: extract_features_batch(vols, [dev] * entries))
            finally:
                sys.setswitchinterval(default)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
