"""The comparisons that decide ``correct``: the program's outputs against
the reference's.

The reference (``reference/``) is an independent implementation on the
CPU, so its numbers are not the program's bits. Each comparison pairs
outputs by what they mean and counts those that disagree beyond the
rounding that two sound f32 implementations of the algorithm show; the
limits on those counts (``limits/<kind>.json``) were set from the
program's and the control's readings on the card (PERF.md, section 2).

Features of a volume. A row of the program pairs with a row of the
reference of the same info flags when
- their locations lie within ``XYZ_TOL`` times the reference's scale,
- their scales agree within ``SCALE_TOL`` (relative),
- a reoriented row's orientation agrees entry by entry within ``ORI_TOL``
  (it tells apart the copies of one feature), and
- their descriptors differ by at most ``DESC_TOL`` in L1 (ranks 0..63).
Each row pairs at most once. A row of either side left unpaired is off;
the number is the share of the rows of both sides that are off.

Two sound f32 implementations differ in more than rounding here: the
refinement fits its parabolas in absolute coordinates, where the f32
determinants cancel, so an ulp of difference in the pyramid moves a
location by up to about half a voxel at the coarse octaves; the patches
then lie elsewhere, and where two orientation peaks nearly tie, the other
one wins. The scale's parabola (over the levels' sigmas) stays well
conditioned, and it is what a loss of precision in the pyramid moves
first, so its tolerance is the tight one.

A group match. The read sets and the ratio test work on integer
descriptors, whose distances f32 holds exactly, so their rows are held
exactly; a pair's Hough inliers are held as a set; its refined transform
and the group vote's weights and log-likelihoods as gaps relative to the
reference.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
XYZ_TOL = 0.25
SCALE_TOL = 1e-3
ORI_TOL = 0.1
DESC_TOL = 128.0
REORIENT = 0x20

# limits/<kind>.json: {number: limit} for the numbers of one kind of check
LIMITS = {p.stem: json.loads(p.read_text())
          for p in sorted((pathlib.Path(__file__).resolve().parent / "limits").glob("*.json"))}


def fields(fs) -> dict:
    """A feature set (an object with FIELDS or a dict) as a dict of numpy
    arrays."""
    get = fs.get if isinstance(fs, dict) else (lambda k: getattr(fs, k))
    n = len(np.asarray(get("xyz")))
    return dict(
        xyz=np.asarray(get("xyz"), np.float32).reshape(n, 3),
        scale=np.asarray(get("scale"), np.float32).reshape(n),
        ori=np.asarray(get("ori"), np.float32).reshape(n, 3, 3),
        eigs=np.asarray(get("eigs"), np.float32).reshape(n, 3),
        info=np.asarray(get("info")).astype(np.uint32).reshape(n),
        desc=np.asarray(get("desc"), np.float32).reshape(n, 64),
    )


def feature_rows_off(got, want) -> tuple:
    """(rows off, rows of both sides) of two feature sets (see the module
    note); an empty pair reads (0, 0)."""
    from scipy.spatial import cKDTree

    g, w = fields(got), fields(want)
    ng, nw = len(g["xyz"]), len(w["xyz"])
    if ng == 0 or nw == 0:
        return ng + nw, ng + nw
    radius = float(XYZ_TOL * w["scale"].max()) * (1 + 1e-6)
    pairs = cKDTree(g["xyz"]).query_ball_tree(cKDTree(w["xyz"]), radius)
    cand = []
    for i, js in enumerate(pairs):
        for j in js:
            if g["info"][i] != w["info"][j]:
                continue
            sw = float(w["scale"][j])
            if float(np.linalg.norm(g["xyz"][i] - w["xyz"][j])) > XYZ_TOL * sw:
                continue
            if abs(float(g["scale"][i]) - sw) > SCALE_TOL * sw:
                continue
            ori_gap = float(np.abs(g["ori"][i] - w["ori"][j]).max())
            if g["info"][i] & REORIENT and ori_gap > ORI_TOL:
                continue
            desc_gap = float(np.abs(g["desc"][i] - w["desc"][j]).sum())
            if desc_gap > DESC_TOL:
                continue
            cand.append((desc_gap, ori_gap if g["info"][i] & REORIENT else 0.0, i, j))
    cand.sort()
    used_g, used_w = np.zeros(ng, bool), np.zeros(nw, bool)
    paired = 0
    for _, _, i, j in cand:
        if not used_g[i] and not used_w[j]:
            used_g[i] = used_w[j] = True
            paired += 1
    return ng + nw - 2 * paired, ng + nw


def share(off: int, total: int) -> float:
    return off / total if total else 0.0


def rel_gap(got, want) -> float:
    """max |got - want| / max(|want|, 1e-300) over the elements; inf on a
    shape mismatch or where one side is not finite and the other is."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        return float("inf")
    if g.size == 0:
        return 0.0
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        return float("inf")
    fin = np.isfinite(w)
    scale = max(float(np.abs(w[fin]).max(initial=0.0)), 1e-300)
    return float(np.abs(g[fin] - w[fin]).max(initial=0.0) / scale)


def rows_differ(got, want) -> int:
    """Rows (first axis) of two arrays that differ in value; a shape
    mismatch counts every row of the larger."""
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape:
        return int(max(len(g), len(w), 1))
    if g.size == 0:
        return 0
    return int((g.reshape(len(g), -1) != w.reshape(len(w), -1)).any(axis=1).sum())


def match_output(got) -> dict:
    """A group call's outputs (the program's objects, or the reference's
    dicts) as the reference's dicts: sets (``fields``), ratio ({query_idx,
    db_idx, ratio}), pairs ({model_idx, input_idx, inlier, num_inliers,
    scale, rot, trans}) and vote ({votes, counts, log_likelihood})."""
    def get(o, k):
        return o[k] if isinstance(o, dict) else getattr(o, k)

    def pair(p):
        t = p if isinstance(p, dict) else p.transform
        return dict(model_idx=np.asarray(get(p, "model_idx")), input_idx=np.asarray(get(p, "input_idx")),
                    inlier=np.asarray(get(p, "inlier"), bool), num_inliers=int(get(p, "num_inliers")),
                    scale=np.float64(get(t, "scale")), rot=np.asarray(get(t, "rot"), np.float64),
                    trans=np.asarray(get(t, "trans"), np.float64))

    return dict(
        sets=[fields(x) for x in got["sets"]],
        ratio=[{k: np.asarray(get(r, k)) for k in ("query_idx", "db_idx", "ratio")} for r in got["ratio"]],
        pairs=[pair(p) for p in got["pairs"]],
        vote={k: np.asarray(get(got["vote"], k)) for k in ("votes", "counts", "log_likelihood")},
    )


def match_numbers(got: dict, want: dict) -> dict:
    """A group call against the reference's, both as ``match_output``
    gives them:

    - ``match_rows_off``: read-set rows, ratio-test rows (the query, its
      database row or its ratio in f32), pairs' match-list entries and the
      vote's counts that differ, and sets, pairs or images missing on
      either side;
    - ``inliers_off``: matches that are a Hough inlier on one side only,
      over the pairs (every inlier of a pair whose match list differs in
      length);
    - ``transform_gap``: the largest gap of a pair's refined scale,
      rotation or translation, relative to the reference's;
    - ``vote_gap``: the largest gap of the vote's weights or
      log-likelihoods, relative to the reference's."""
    rows = abs(len(got["sets"]) - len(want["sets"])) + abs(len(got["ratio"]) - len(want["ratio"]))
    for g, w in zip(got["sets"], want["sets"]):
        rows += sum(rows_differ(g[k], w[k]) for k in FIELDS) if len(g["xyz"]) == len(w["xyz"]) \
            else max(len(g["xyz"]), len(w["xyz"]))
    for g, w in zip(got["ratio"], want["ratio"]):
        rows += max(rows_differ(g["query_idx"], w["query_idx"]), rows_differ(g["db_idx"], w["db_idx"]),
                    rows_differ(g["ratio"].astype(np.float32), w["ratio"].astype(np.float32)))
    rows += abs(len(got["pairs"]) - len(want["pairs"]))
    inliers, tgap = 0, 0.0
    for g, w in zip(got["pairs"], want["pairs"]):
        rows += rows_differ(g["model_idx"], w["model_idx"]) + rows_differ(g["input_idx"], w["input_idx"])
        if len(g["inlier"]) == len(w["inlier"]):
            inliers += int((g["inlier"] != w["inlier"]).sum())
        else:
            inliers += int(g["inlier"].sum() + w["inlier"].sum())
        tgap = max(tgap, rel_gap(g["scale"], w["scale"]), rel_gap(g["rot"], w["rot"]), rel_gap(g["trans"], w["trans"]))
    rows += rows_differ(got["vote"]["counts"], want["vote"]["counts"])
    vgap = max(rel_gap(got["vote"]["votes"], want["vote"]["votes"]),
               rel_gap(got["vote"]["log_likelihood"], want["vote"]["log_likelihood"]))
    return {"match_rows_off": rows, "inliers_off": inliers, "transform_gap": tgap, "vote_gap": vgap}


def checks(kind: str, numbers: dict) -> list:
    """[(name, value, limit)] for every number, each held to its limit in
    limits/<kind>.json ("extraction" or "match")."""
    return [(k, v, LIMITS[kind][k]) for k, v in numbers.items()]
