#!/usr/bin/env python3
"""The multi-card layer (sift3d_torch.dist) over several real cards.

    python3 scripts/torch_multicard_probe.py [--devices cuda:0,cuda:1,...] [--dims Z,Y,X]

Needs two or more devices; by default every CUDA card, on chip_smoke.py's
32 T1-grid volumes (phase 10's), given as host arrays. Holds every result
to the single-card one, bit for bit, and times it (host clock, after a
device sync on every card; median of 5 calls after a warm-up unless it
says otherwise):

- extract_features_many on all 32 volumes on the first card (the
  reference), on 8 of them on each card alone, extract_features_batch
  over every card (one host thread a card) and over as many entries of
  the first card;
- sharded_knn over every card on chip_smoke.py's 48,000 tiled GoH rows
  (k = 5) beside knn_search on the first card (median of 10);
- copies from the first card to each other card: the kNN database (12.3
  MB) and one volume (28.9 MB), GB/s (median of 10);
- solve_similarity_sharded over every card, bit-equal to the first card's
  solve, on 100,000 weighted correspondences;
- one process a card (scripts/torch_multihost_worker.py, gloo): each
  rank's extraction ms of its share and the exchange's ms and bytes, the
  gathered sets equal to the reference.

Prints the card lines (nvidia-smi name and power limit) and one JSON line.
--devices cpu,cpu,... with small --dims rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None)
    ap.add_argument("--dims", default="182,218,182")
    args = ap.parse_args()

    import torch

    from chip_smoke import rotation, shifted_volumes, tiled_goh_rows
    from sift3d_torch import extract_features, extract_features_batch, extract_features_many
    from sift3d_torch.dist.gather import sharded_knn
    from sift3d_torch.dist.solve import solve_similarity_sharded
    from sift3d_torch.match.knn import knn_search
    from sift3d_torch.match.solve import solve_similarity
    from sift3d_torch.utils.synthetic import synthetic_blob_texture

    if args.devices is None:
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in args.devices.split(",")]
    if len(devices) < 2:
        print("needs two or more devices", file=sys.stderr)
        return 2
    n, first = len(devices), devices[0]

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def wall_ms(fn, calls=5):
        fn()
        walls = []
        for _ in range(calls):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    cards = []
    if first.type == "cuda":
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip().splitlines()
    dims = tuple(int(v) for v in args.dims.split(","))
    base = torch.from_numpy(synthetic_blob_texture(dims, seed=7)).to(first)
    vols = [v.cpu().numpy() for v in shifted_volumes(base)[0]]
    out = {"cards": cards, "devices": [str(d) for d in devices], "volumes": len(vols)}

    want = extract_features_many(vols, device=first)
    out["many_first_card_ms"] = wall_ms(lambda: extract_features_many(vols, device=first))
    out["many_8_each_card_ms"] = {str(d): wall_ms(lambda: extract_features_many(vols[:8], device=d))
                                  for d in devices}
    for label, mesh in (("every_card", devices), ("first_card_entries", [first] * n)):
        got = extract_features_batch(vols, mesh)
        out[f"placement_{label}_equal"] = all(
            len(g) == len(w) and all(np.array_equal(getattr(g, k), getattr(w, k)) for k in FIELDS)
            for g, w in zip(got, want))
        out[f"placement_{label}_ms"] = wall_ms(lambda: extract_features_batch(vols, mesh))

    x = torch.as_tensor(tiled_goh_rows(extract_features(base, device=first)), dtype=torch.float32, device=first)
    ref = knn_search(x, x, 5, device=first)
    got = sharded_knn(x, x, 5, devices)
    out["sharded_knn_rows"] = int(x.shape[0])
    out["sharded_knn_equal"] = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
    out["sharded_knn_every_card_ms"] = wall_ms(lambda: sharded_knn(x, x, 5, devices), 10)
    out["knn_first_card_ms"] = wall_ms(lambda: knn_search(x, x, 5, device=first), 10)

    vol = torch.from_numpy(vols[0]).to(first)
    copies = {}
    for d in devices[1:]:
        for label, t in (("knn_db", x), ("volume", vol)):
            ms = wall_ms(lambda: t.to(d), 10)
            copies[f"{first}->{d} {label}"] = [t.numel() * 4, ms, t.numel() * 4 / ms / 1e6]
    out["copies_bytes_ms_gbps"] = copies

    rng = np.random.default_rng(9)
    p = rng.uniform(20, 160, (100_000, 3)).astype(np.float32)
    q = (1.1 * p @ rotation(9).T + np.array([3.0, -2.0, 5.0]) + rng.normal(0, 1.0, p.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, p.shape[0]).astype(np.float32)
    a, b = solve_similarity_sharded(p, q, w, devices), solve_similarity(p, q, w, device=first)
    out["sharded_solve_equal"] = bool(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "vols.npy"), np.stack(vols))
        worker = str(REPO / "scripts" / "torch_multihost_worker.py")
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, worker, "file://" + os.path.join(tmp, "pg"), str(r), str(n),
                                   os.path.join(tmp, "vols.npy"), outs[r], "--device", str(d)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r, d in enumerate(devices)]
        logs = []
        try:
            for pr in procs:
                logs.append(pr.communicate(timeout=600)[0])
        finally:
            for pr in procs:
                pr.kill()
                pr.wait()
        for r, pr in enumerate(procs):
            if pr.returncode != 0:
                raise RuntimeError(f"rank {r} failed (rc {pr.returncode}):\n{logs[r][-4000:]}")
        ranks = [dict(np.load(o)) for o in outs]
    out["processes_extract_ms"] = [float(r["extract_ms"]) for r in ranks]
    out["processes_exchange_ms"] = [float(r["exchange_ms"]) for r in ranks]
    out["processes_exchange_bytes"] = int(ranks[0]["exchange_bytes"])
    out["processes_equal"] = all(
        np.array_equal(r[f"set{i}_{k}"], getattr(s, k)) for r in ranks for i, s in enumerate(want) for k in FIELDS)
    for line in cards:
        print(line)
    print(json.dumps(out))
    ok = all(v for k, v in out.items() if k.endswith("_equal"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
