"""What the extraction mixes share: the cohort of host volumes, the
sample whose outputs are compared, and the check against the reference."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

import compare
from sift3d_torch.core.config import DEFAULT_CONFIG
from traffic.volumes import host_volumes


def build_cache_state() -> str:
    """'hit' when the port's kernel library for its current sources is
    already built in the checkout, else 'miss' (the first run builds it)."""
    from sift3d_torch.kernels import cuda_lib

    return "hit" if cuda_lib.library_path().exists() else "miss"


def sample(seed: int, check: int, order: List[int], groups: Optional[Sequence[Sequence[int]]]) -> List[int]:
    """The volumes whose every output in the window is compared.

    groups: the volumes each card extracts as one batch, in batch order
    (None for a mix that takes one volume at a time). Each group gives its
    first and last volume, and then, while fewer than `check` are drawn,
    one volume from the seed out of each half of each group in turn, so
    that every card and both halves of every batch are in the sample.
    Without groups: the first `check` volumes of the visiting order, so
    that even a short window meets one."""
    if groups is None:
        return sorted(order[:check])
    rng = np.random.default_rng(int(seed) + 1)
    picked = []
    for g in groups:
        picked += [g[0], g[-1]]
    halves = [h for g in groups for h in (g[: len(g) // 2], g[len(g) // 2 :])]
    while len(set(picked)) < min(check, sum(len(g) for g in groups)):
        for h in halves:
            rest = [i for i in h if i not in picked]
            if rest and len(set(picked)) < check:
                picked.append(int(rng.choice(rest)))
    return sorted(set(picked))


def setup(config: dict, params: dict, seed: int, devices: List[str], say: Callable[[str], None],
          count: int, groups: Optional[Sequence[Sequence[int]]] = None) -> dict:
    """`count` distinct host volumes of the configuration's grid (made on
    devices[0]), the order in which a mix that takes one at a time visits
    them (a permutation drawn from the seed) and the sample (``sample``).
    state["cfg"] is the port's SiftConfig with the configuration's `sift`
    changes."""
    grid = config["grid_zyx"]
    vols = host_volumes(grid, seed, count, params["blobs"], devices[0])
    order = np.random.default_rng(int(seed)).permutation(count).tolist()
    checked = sample(seed, params["check_volumes"], order, groups)
    if torch.device(devices[0]).type == "cuda":
        say(f"setup: kernel build cache {build_cache_state()}")
    say(f"setup: {count} host volumes {tuple(grid)} f32, {sum(v.nbytes for v in vols) / 1e9:.3f} GB; "
        f"checked volumes {checked}")
    return dict(config=config, params=params, devices=list(devices), vols=vols, order=order, sample=checked,
                outputs={i: [] for i in checked}, say=say,
                cfg=dataclasses.replace(DEFAULT_CONFIG, **config["sift"]))


def keep(state: dict, indices, feature_sets) -> None:
    """Keep the outputs of the sampled volumes among one call's (inside
    the window, so only references); a volume that the call was given and
    returned no output for keeps None."""
    feature_sets = list(feature_sets)
    for j, i in enumerate(indices):
        if i in state["outputs"]:
            state["outputs"][i].append(feature_sets[j] if j < len(feature_sets) else None)


def distinct(outputs: list) -> dict:
    """{digest: (fields, count)} of a volume's kept outputs (None: the
    missing ones)."""
    out = {}
    for fs in outputs:
        f = None if fs is None else compare.fields(fs)
        key = None if f is None else _digest(f)
        out[key] = (f, out.get(key, (None, 0))[1] + 1)
    return out


def report_counts(state: dict, feature_sets) -> None:
    counts = [len(fs) for fs in feature_sets]
    state["say"](f"setup: features a volume in the warm call: min {min(counts)}, median {int(np.median(counts))}, "
                 f"max {max(counts)}, total {sum(counts)}")


def _digest(out: dict) -> bytes:
    h = hashlib.sha1()
    for k in compare.FIELDS:
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.digest()


def check(state: dict, control: bool, say) -> tuple:
    """(numbers, outputs compared, outputs over the limit): every kept
    output of each sampled volume against the reference's features of that
    volume, computed on the CPU (the volumes in parallel threads) once the
    program's device memory is freed.
    ``feature_rows_off_share`` is the largest share of rows off
    (``compare.feature_rows_off``) of an output; an output missing reads 1.
    control: the reference with the TF32 blur takes each output's place."""
    from reference.extract import features

    if torch.device(state["devices"][0]).type == "cuda":
        torch.cuda.empty_cache()
    conf = state["config"]
    limit = compare.LIMITS["extraction"]["feature_rows_off_share"]
    t0 = time.perf_counter()
    jobs = [(i, False) for i in state["sample"]] + [(i, True) for i in state["sample"] if control]
    with concurrent.futures.ThreadPoolExecutor(max(1, min(len(jobs), (os.cpu_count() or 2) // 2))) as ex:
        refs = dict(zip(jobs, ex.map(lambda j: features(state["vols"][j[0]], conf["sift"], conf["descriptor"],
                                                        control=j[1]), jobs)))
    say(f"check: the reference's features of {len(state['sample'])} volumes, {time.perf_counter() - t0:.1f} s")
    worst, compared, failed = 0.0, 0, 0
    for i in state["sample"]:
        want = refs[(i, False)]
        outs = distinct(state["outputs"][i])
        if control and outs:
            outs = {b"control": (compare.fields(refs[(i, True)]), sum(n for _, n in outs.values()))}
        vol_worst = 0.0
        for out, n in outs.values():
            s = 1.0 if out is None else compare.share(*compare.feature_rows_off(out, want))
            vol_worst = max(vol_worst, s)
            compared += n
            failed += n * (s > limit)
        worst = max(worst, vol_worst)
        say(f"check: volume {i}: {len(want['xyz'])} reference rows, {sum(n for _, n in outs.values())} outputs "
            f"({len(outs)} distinct), largest share of rows off {vol_worst}")
    return compare.checks("extraction", {"feature_rows_off_share": worst}), compared, failed
