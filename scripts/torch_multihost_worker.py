#!/usr/bin/env python3
"""One process of a multi-process run of the PyTorch port (sift3d_torch.dist.multihost).

    python3 scripts/torch_multihost_worker.py INIT_URL RANK WORLD VOLUMES.npy OUT.npz \
        [--device cpu|cuda:N] [--entries E]

Start WORLD of them, RANK 0 .. WORLD-1, with the same INIT_URL (such as
file:///tmp/dir/pg, a file that does not exist yet, or tcp://localhost:PORT)
and the same VOLUMES.npy (a [V, Z, Y, X] f32 array). Each process joins the
gloo process group and runs the multi-process path over a local mesh of E
entries on --device:

1. extract_features_multihost: its round-robin share of the volumes, by
   placement over its mesh, once to warm up and once timed (host clock
   from a barrier to the end of its own extraction, after a device sync);
2. gather_featuresets: the one exchange, timed (host clock, after a
   barrier), with the bytes of the exchanged tables;
3. the group vote (GroupMatcher.match_all_to_all) with the kNN sharded over
   the ranks, and sharded_knn on the whole descriptor database;
4. solve_similarity_sharded spanning the ranks, on seeded correspondences;
5. gather_featuresets with volume 0 owned by every rank, and with no owner:
   each must raise.

It writes everything to OUT.npz (the gathered sets as set{i}_{field}, the
votes, the kNN, the solve with its inputs, the two error messages, the
extraction's ms, the exchange's ms and bytes), for a caller to hold against the single-process
results. It imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
SOLVE_SEED = 42
SOLVE_ROWS = 1000


def solve_inputs():
    """Seeded weighted correspondences of a similarity (scale 2, shift
    (1, 2, 3)) with noise."""
    rng = np.random.default_rng(SOLVE_SEED)
    p = rng.uniform(-10, 10, (SOLVE_ROWS, 3)).astype(np.float32)
    q = (2.0 * p + np.array([1.0, 2.0, 3.0]) + rng.normal(0, 0.01, (SOLVE_ROWS, 3))).astype(np.float32)
    return p, q, rng.uniform(0.5, 1.5, SOLVE_ROWS).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("init")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("volumes")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--entries", type=int, default=1)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from sift3d_torch.dist import multihost
    from sift3d_torch.dist.gather import sharded_knn
    from sift3d_torch.dist.solve import solve_similarity_sharded
    from sift3d_torch.match.groupvote import GroupMatcher

    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = [torch.device(args.device)] * args.entries
    multihost.initialize(args.init, args.world, args.rank)
    try:
        vols = list(np.load(args.volumes))
        mine = multihost.my_volume_ids(len(vols))
        multihost.extract_features_multihost(vols, mesh=mesh)
        dist.barrier()
        t0 = time.perf_counter()
        partial = multihost.extract_features_multihost(vols, mesh=mesh)
        if mesh[0].type == "cuda":
            torch.cuda.synchronize(mesh[0])
        extract_ms = (time.perf_counter() - t0) * 1e3
        if [i for i, f in enumerate(partial) if f is not None] != mine:
            raise AssertionError(f"rank {args.rank} extracted other volumes than {mine}")
        dist.barrier()
        t0 = time.perf_counter()
        sets = multihost.gather_featuresets(partial)
        exchange_ms = (time.perf_counter() - t0) * 1e3
        out = {f"set{i}_{k}": getattr(s, k) for i, s in enumerate(sets) for k in FIELDS}

        vote = GroupMatcher(sets, mesh=mesh).match_all_to_all()
        db = np.concatenate([s.desc for s in sets])
        kdist, kidx = sharded_knn(db, db, 5, mesh)
        p, q, w = solve_inputs()
        scale, rot, trans = solve_similarity_sharded(p, q, w, mesh)

        errors = []
        for claim in ([sets[0]] + [None] * (len(sets) - 1), [None] * len(sets)):
            try:
                multihost.gather_featuresets(claim)
            except ValueError as e:
                errors.append(str(e))
            else:
                errors.append("")
        out.update(
            rank=args.rank, mine=np.asarray(mine), n_sets=len(sets), extract_ms=extract_ms, exchange_ms=exchange_ms,
            exchange_bytes=sum(len(s) for s in sets) * multihost.TABLE_COLUMNS * 4,
            votes=vote.votes, counts=vote.counts, log_likelihood=vote.log_likelihood,
            knn_dist=kdist.cpu().numpy(), knn_idx=kidx.cpu().numpy(),
            p=p, q=q, w=w, scale=scale, rot=rot, trans=trans, errors=np.asarray(errors),
        )
        np.savez(args.out, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
