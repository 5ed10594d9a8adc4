#!/usr/bin/env python3
"""How many threads each placed entry's staging copies should take
(sift3d_torch.dist.batch.copy_threads, pipeline.staging.shared_copy).

    python3 scripts/torch_placement_copy_share.py [--devices cuda:0,cuda:1,...] [--dims Z,Y,X]
        [--volumes 128] [--rounds 3] [--calls 4]

extract_features_batch over every CUDA card (or --devices) on `volumes`
distinct host volumes a call (f32 numpy arrays: four blob textures, each
with its shifted, noisy copies as chip_smoke.py's phase 10 makes them),
in modes that differ only in how each entry copies its host volumes into
the staging ring:

- openmp: torch's intra-op copy, an OpenMP team of one thread a core an
  entry (the route before shared_copy);
- k1, k2, k4: shared_copy with 1, 2 and 4 threads an entry;
- share: shared_copy with (this process's usable cores) // entries.

The modes run in turns, `rounds` times (the order reversed every other
round), `calls` calls a mode a turn after one warm-up call each; a call's
wall ends in a sync of every card. Per mode: the walls, the median and
quartiles of volumes/s, and from one more call under TRACER.record() the
entries' `input` and `emit` host ms a call (summed over entries) and the
counter shared_copy_volumes. Every mode's FeatureSets equal openmp's, bit
for bit. Prints the card lines (nvidia-smi name and power limit) and one
JSON line. --devices cpu,cpu,... with small --dims rehearses the control
flow on the CPU (no staging ring there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
BASE_SEEDS = (7, 8, 9, 10)


def host_volumes(dims, count: int, dev):
    """count f32 host arrays: shifted, noisy copies of len(BASE_SEEDS) blob
    textures made on dev."""
    import torch

    from chip_smoke import shifted_volumes
    from sift3d_torch.utils.synthetic import synthetic_blob_texture

    per = -(-count // len(BASE_SEEDS))
    vols = []
    for seed in BASE_SEEDS:
        base = torch.from_numpy(synthetic_blob_texture(dims, seed=seed)).to(dev)
        vols += [v.cpu().numpy() for v in shifted_volumes(base, per)[0]]
    return [v if v.flags.writeable else v.copy() for v in vols[:count]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None)
    ap.add_argument("--dims", default="182,218,182")
    ap.add_argument("--volumes", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args()

    import torch

    from sift3d_torch.dist import batch
    from sift3d_torch.dist.mesh import make_mesh
    from sift3d_torch.utils.timing import TRACER

    mesh = make_mesh(devices=args.devices.split(",") if args.devices else None)
    cuda = mesh[0].type == "cuda"
    cards = []
    if cuda:
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip().splitlines()
    dims = tuple(int(d) for d in args.dims.split(","))
    vols = host_volumes(dims, args.volumes, mesh[0])
    entries = min(len(mesh), len(vols))
    cores = len(os.sched_getaffinity(0))
    rule = batch.copy_threads
    modes = {"openmp": 0, "k1": 1, "k2": 2, "k4": 4, "share": cores // entries}

    def sync():
        if cuda:
            for d in sorted({d.index for d in mesh}):
                torch.cuda.synchronize(d)

    def call(k):
        batch.copy_threads = lambda n: k  # 0: no shared_copy, torch's team
        try:
            return batch.extract_features_batch(vols, mesh)
        finally:
            batch.copy_threads = rule

    walls = {m: [] for m in modes}
    first = {m: call(k) for m, k in modes.items()}  # the warm-ups
    same = {m: all(len(g) == len(w) and all(bool((getattr(g, f) == getattr(w, f)).all()) for f in FIELDS)
                   for g, w in zip(first[m], first["openmp"])) for m in modes}
    del first
    for r in range(args.rounds):
        for m in (list(modes) if r % 2 == 0 else list(modes)[::-1]):
            for _ in range(args.calls):
                sync()
                t0 = time.perf_counter()
                call(modes[m])
                sync()
                walls[m].append((time.perf_counter() - t0) * 1e3)
    traced = {}
    for m, k in modes.items():
        with TRACER.record():
            call(k)
            sync()
            totals = TRACER.totals()
            counts = dict(TRACER.counts)
        traced[m] = {"input_host_ms": totals["input"].host_ms if "input" in totals else None,
                     "emit_host_ms": totals["emit"].host_ms if "emit" in totals else None,
                     "shared_copy_volumes": counts.get("shared_copy_volumes", 0),
                     "staged_volumes": counts.get("staged_volumes", 0)}
    out = {"cards": cards, "devices": [str(d) for d in mesh], "entries": entries, "cores": cores,
           "rule_threads": rule(entries), "volumes": len(vols), "dims": dims, "rounds": args.rounds,
           "calls": args.calls, "modes": modes, "same_bits_as_openmp": same}
    for m in modes:
        rates = [len(vols) / w * 1e3 for w in walls[m]]
        q = statistics.quantiles(rates, n=4) if len(rates) > 1 else [rates[0]] * 3
        out[m] = {"volumes_per_s_median": statistics.median(rates), "q1": q[0], "q3": q[2],
                  "walls_ms": walls[m], **traced[m]}
    for line in cards:
        print(line)
    print(json.dumps(out))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
