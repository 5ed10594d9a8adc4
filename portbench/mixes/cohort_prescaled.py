"""A cohort extracted with featExtract -2+ on one card: `batch` host volumes
of the configuration's grid a call through
``sift3d_torch.extract_features_many(..., prescale=<the configuration's
prescale>)``, back to back, cycling through `distinct` distinct volumes.
The program stages each volume at its own size, doubles it on the card and
runs a shape group in the sub-batches its planner fits to the card. A unit
is one call; it counts its volumes.

The sample (``extraction.sample``) takes the first and last volume of each
sub-batch that the planner forms for the warm call (read from the program's
planner just before it), and more from the seed up to `check_volumes`. The
check compares every kept output of a sampled volume with
``reference.prescaled.features`` of it, under the extraction limits.
"""

from __future__ import annotations

import concurrent.futures
import time

import torch

import compare
import extraction
from sift3d_torch import extract_features_many


def setup(config, params, seed, devices, say):
    first = [j % params["distinct"] for j in range(params["batch"])]  # the first call's batch
    state = extraction.setup(config, params, seed, devices, say, params["distinct"], groups=[first])
    state.update(next=0, seed=seed)
    return state


def _call(state, spans):
    p, n = state["params"], state["params"]["distinct"]
    ids = [(state["next"] + j) % n for j in range(p["batch"])]
    state["next"] = (state["next"] + p["batch"]) % n
    out = extract_features_many([state["vols"][i] for i in ids], state["cfg"], device=state["devices"][0],
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
    output of each sampled volume against ``reference.prescaled``'s
    features of that volume, computed on the CPU once the program's device
    memory is freed, two volumes at a time (a doubled volume's reference
    peaks near 12 GB of host memory: 29.4 GB a run).
    ``feature_rows_off_share``: the largest share of rows off
    (``compare.feature_rows_off``) of an output; an output missing reads 1.
    control: the reference with the TF32 blur takes each output's place,
    one volume at a time: its rounding leaves flat stretches of the doubled
    volume's DoGs full of extrema, and two such volumes at once outgrew a
    one-card machine's 96 GiB."""
    from reference.prescaled import features

    if torch.device(state["devices"][0]).type == "cuda":
        torch.cuda.empty_cache()
    conf = state["config"]
    limit = compare.LIMITS["extraction"]["feature_rows_off_share"]

    def ref(i, tf32):
        return features(state["vols"][i], conf["sift"], conf["descriptor"], control=tf32)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        refs = {(i, False): r for i, r in zip(state["sample"], ex.map(lambda i: ref(i, False), state["sample"]))}
    if control:
        refs.update({(i, True): ref(i, True) for i in state["sample"]})
    say(f"check: the reference's -2+ features of {len(state['sample'])} volumes, {time.perf_counter() - t0:.1f} s")
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
