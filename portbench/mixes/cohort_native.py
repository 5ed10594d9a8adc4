"""A cohort of native-space scans extracted with featExtract -w on one card:
`batch` host scans of the configuration's anisotropic grid a call, each a
``sift3d_torch.Scan`` with the configuration's voxel size and world
matrix, through ``sift3d_torch.extract_features_many(...,
prescale="isotropic")``, back to back, cycling through `distinct` distinct
scans (``traffic/native.py``). The program stages each scan at its own
size, resamples it on the card to the isotropic grid and returns its
features in world millimetres. A unit is one call; it counts its volumes.

The sample (``extraction.sample``) takes the first and last volume of each
sub-batch that the planner forms for the warm call (read from the
program's planner just before it), and more from the seed up to
`check_volumes`. The check compares every kept output of a sampled volume
with ``reference.isotropic.features`` of it, under the extraction limits.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import torch

import compare
import extraction
from sift3d_torch import Scan, extract_features_many
from sift3d_torch.core.config import DEFAULT_CONFIG
from traffic.native import native_volumes


def setup(config, params, seed, devices, say):
    n = params["distinct"]
    vols = native_volumes(config["grid_zyx"], config["voxel_size_xyz_mm"], seed, n, params["blobs"], devices[0])
    world = np.asarray(config["world_matrix"], np.float64)
    order = np.random.default_rng(int(seed)).permutation(n).tolist()
    first = [j % n for j in range(params["batch"])]  # the first call's batch
    checked = extraction.sample(seed, params["check_volumes"], order, [first])
    if torch.device(devices[0]).type == "cuda":
        say(f"setup: kernel build cache {extraction.build_cache_state()}")
    say(f"setup: {n} host scans {tuple(config['grid_zyx'])} f32 at {tuple(config['voxel_size_xyz_mm'])} mm, "
        f"{sum(v.nbytes for v in vols) / 1e9:.3f} GB")
    return dict(config=config, params=params, devices=list(devices), vols=vols, world=world, order=order,
                sample=checked, outputs={i: [] for i in checked}, say=say, seed=seed, next=0,
                scans=[Scan(v, tuple(config["voxel_size_xyz_mm"]), world) for v in vols],
                cfg=dataclasses.replace(DEFAULT_CONFIG, **config["sift"]))


def _call(state, spans):
    p, n = state["params"], state["params"]["distinct"]
    ids = [(state["next"] + j) % n for j in range(p["batch"])]
    state["next"] = (state["next"] + p["batch"]) % n
    out = extract_features_many([state["scans"][i] for i in ids], state["cfg"], device=state["devices"][0],
                                timer=spans.timer, descriptor=state["config"]["descriptor"],
                                prescale=state["config"]["prescale"])
    return ids, out


def _planned_groups(state, ids):
    """The sub-batches the program's planner forms for a call on ids, now."""
    from sift3d_torch.pipeline import extract

    dev = torch.device(state["devices"][0])
    sizes = extract.plan_subbatches(state["config"]["extraction_grid_zyx"], len(ids), extract.device_budget(dev))
    groups, at = [], 0
    for size in sizes:
        groups.append(ids[at : at + size])
        at += size
    return groups


def warmup(state, spans):
    p = state["params"]
    groups = _planned_groups(state, [j % p["distinct"] for j in range(p["batch"])])
    ids, out = _call(state, spans)
    extraction.report_counts(state, out)
    state["sample"] = extraction.sample(state["seed"], p["check_volumes"], state["order"], groups)
    state["outputs"] = {i: [] for i in state["sample"]}
    state["say"](f"setup: the warm call's sub-batches {[len(g) for g in groups]}; checked volumes {state['sample']}")
    state["next"] = 0


def unit(state, spans):
    ids, out = _call(state, spans)
    extraction.keep(state, ids, out)
    return len(ids)


def check(state: dict, control: bool, say) -> tuple:
    """(numbers, outputs compared, outputs over the limit): every kept
    output of each sampled volume against ``reference.isotropic``'s
    features of that volume, in world mm, computed on the CPU once the
    program's device memory is freed (the volumes in parallel threads, the
    control's one at a time: its TF32 rounding fills flat stretches of the
    DoGs with extrema). ``feature_rows_off_share``: the largest share of
    rows off (``compare.feature_rows_off``) of an output; an output missing
    reads 1. control: the reference with the TF32 blur takes each
    output's place."""
    from reference.isotropic import features

    if torch.device(state["devices"][0]).type == "cuda":
        torch.cuda.empty_cache()
    conf = state["config"]
    limit = compare.LIMITS["extraction"]["feature_rows_off_share"]

    def ref(i, tf32):
        return features(state["vols"][i], conf["voxel_size_xyz_mm"], state["world"], conf["sift"],
                        conf["descriptor"], control=tf32)

    t0 = time.perf_counter()
    threads = max(1, min(len(state["sample"]), (os.cpu_count() or 2) // 2))
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        refs = {(i, False): r for i, r in zip(state["sample"], ex.map(lambda i: ref(i, False), state["sample"]))}
    if control:
        refs.update({(i, True): ref(i, True) for i in state["sample"]})
    say(f"check: the reference's -w features of {len(state['sample'])} volumes, {time.perf_counter() - t0:.1f} s")
    worst, compared, failed = 0.0, 0, 0
    for i in state["sample"]:
        want = refs[(i, False)]
        outs = extraction.distinct(state["outputs"][i])
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
