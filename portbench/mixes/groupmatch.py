"""One group match a unit: ``featmatch -r -s4 -n<k> --all-to-all
--refine``'s calls on `count` .key sets, without its output files. The
sets are made from the seed (``traffic/keysets``) and written once, at
set-up, into a directory under the run's TMPDIR; a unit reads them
(``io.keyfile.read_text``), keeps the reoriented features, runs the ratio
test of every set against set 0 (``ratio_match_stacked``), the Hough vote
and refined transform of every pair (``match_keys_stacked``) and the
group vote (``GroupMatcher.match_all_to_all``)."""

from __future__ import annotations

import dataclasses
import hashlib
import shutil
import tempfile

import numpy as np

import compare
import roofline
from traffic import keysets
from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.io import keyfile
from sift3d_torch.match.groupvote import GroupMatcher
from sift3d_torch.match.pairwise import match_keys_stacked, ratio_match_stacked


def setup(config, params, seed, devices, say):
    grid = config["grid_zyx"]
    octaves = len(roofline.octave_shapes(grid))
    sets = keysets.group(seed, params, grid, octaves)
    directory = tempfile.mkdtemp(prefix="portbench_keys_")
    paths = keysets.write_group(sets, directory)
    cfg = dataclasses.replace(DEFAULT_CONFIG, knn_neighbors=config["featmatch"]["neighbors"])
    say(f"setup: {len(paths)} .key sets of {params['rows']} rows written to the run's TMPDIR")
    return dict(config=config, params=params, devices=list(devices), paths=paths, directory=directory,
                cfg=cfg, outputs=[], say=say)


def _call(state, spans):
    cfg, dev = state["cfg"], state["devices"][0]
    with spans.span("read"):
        sets = [keyfile.read_text(p, eig_threshold=cfg.eig_threshold)[0].remove_non_reoriented()
                for p in state["paths"]]
    with spans.span("ratio_match"):
        ratio = ratio_match_stacked(sets[1:], sets[0], cfg, dev)
    with spans.span("hough"):
        pairs = match_keys_stacked(sets[0], sets[1:], cfg, refine=True, matches=ratio, device=dev)
    with spans.span("group_vote"):
        vote = GroupMatcher(sets, list(range(len(sets))), -1.0, cfg, dev).match_all_to_all()
    return dict(sets=sets, ratio=ratio, pairs=pairs, vote=vote)


def warmup(state, spans):
    out = _call(state, spans)
    state["vote_rows"] = sum(len(s) for s in out["sets"])
    state["say"]("setup: per pair against set 0, ratio-test survivors (d1/d2 < 0.64 on squared distances): "
          + " ".join(str(int((r.ratio < 0.64).sum())) for r in out["ratio"]))
    state["say"]("setup: per pair, Hough inliers: " + " ".join(str(p.num_inliers) for p in out["pairs"]))


def unit(state, spans):
    state["outputs"].append(_call(state, spans))
    return 1


def _digest(out: dict) -> bytes:
    h = hashlib.sha1()
    for part in (out["sets"], out["ratio"], out["pairs"], [out["vote"]]):
        for d in part:
            for k in sorted(d):
                h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.digest()


def check(state, control, say):
    """(numbers, calls compared, calls over a limit): every call of the
    window against the reference's group call on the same files, computed
    on the CPU; equal calls are compared once, and each number is the
    worst call's. control: the reference one precision step down takes the
    program's place."""
    from reference.match import group

    outs = {}
    for got in state["outputs"]:
        got = compare.match_output(got)
        key = _digest(got)
        outs[key] = (got, outs.get(key, (None, 0))[1] + 1)
    want = compare.match_output(group(state["paths"], state["cfg"].knn_neighbors))
    if control and outs:
        ctrl = compare.match_output(group(state["paths"], state["cfg"].knn_neighbors, control=True))
        outs = {b"control": (ctrl, len(state["outputs"]))}
    shutil.rmtree(state["directory"], ignore_errors=True)
    worst, failed = {}, 0
    for got, n in outs.values():
        numbers = compare.match_numbers(got, want)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0), v)
        failed += n * any(v > compare.LIMITS["match"][k] for k, v in numbers.items())
    say(f"check: reference group call, {sum(len(s['xyz']) for s in want['sets'])} rows, "
        f"inliers {[p['num_inliers'] for p in want['pairs']]}; {len(state['outputs'])} calls, {len(outs)} distinct")
    return compare.checks("match", worst), len(state["outputs"]), failed
