"""featmatch — the PyTorch port's group feature matching CLI.

Usage (mirrors featMatchMultiple/featMatchMultiple.cpp:398-486):

    python -m sift3d_torch.cli.featmatch [options] <keys1> <keys2> ...

      -o <file> : report file name (default report.txt)
      -s <N>    : peak/valley handling: 0 peaks only, 1 valleys only,
                  2 split peak+valley reruns, 4 both (default)
      -r / -r-  : use only reoriented features (default) / only unoriented
      -n <N>    : nearest neighbors for group voting (default 5)
      -f <file> : read key-file list from a text file
      -g <W>    : geometry weight for group voting: augment descriptors
                  with W * xyz / scale (default -1 = off)
      -d<N>     : CUDA device index (default 0); the port runs on the card,
                  through its hand-written kernels, and needs one
      --all-to-all : run the soft-vote group matcher (matchAllToAll)
                     in addition to pairwise registration
      --refine  : refit each pairwise transform by weighted least squares
                  over its Hough inliers
      --shard-match : shard the group-vote kNN's queries over every CUDA
                      card (``dist.gather.sharded_knn``); the output files
                      are the same bytes as without it

Outputs (same files, same bytes as ``sift3d.cli.featmatch``):
_command.txt, _names.txt, feature_count.txt, per-pair .matches.img1/img2/
info.txt + .trans.txt + .trans-inverse.txt + .update.key, report.txt; with
--all-to-all also report.all.txt, matching_votes.txt and vote_count.txt.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.core.device import resolve_device
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.io import keyfile, native
from sift3d_torch.match import groupvote
from sift3d_torch.match.pairwise import match_keys_stacked, ratio_match_stacked
from sift3d_torch.utils.textfile import read_lines
from sift3d_torch.utils.timing import TRACER


def match_all_to_one(names, feature_sets, out_report="report.txt", cfg=DEFAULT_CONFIG, refine=False,
                     device=None, timer=None):
    """Pairwise registration of every image to image 0
    (featMatchMultiple.cpp:147-395). Every pair shares image 0 as the
    database, so the ratio tests of all query sets run as ONE launch of M2
    over the concatenated queries (``pairwise.ratio_match_stacked``) and the
    Hough votes of all pairs as one stack, one launch of M3's scores and
    one of its inlier masks (``pairwise.match_keys_stacked``); then each
    pair's files are written in order."""
    dev = resolve_device(device)
    timer = timer or TRACER
    f1 = feature_sets[0]
    with timer.stage("ratio_match"):
        stacked = ratio_match_stacked(feature_sets[1:], f1, cfg, dev)
    with timer.stage("hough"):
        results = match_keys_stacked(f1, feature_sets[1:], cfg, refine=refine, matches=stacked, device=dev)
    for i, res in enumerate(results, start=1):
        with timer.stage("write"):
            write_pair_files(names[0], names[i], f1, feature_sets[i], res, out_report, timer)
    return 0


# one matched feature per line: image, x y z s, the match's tag, DistSqr (0)
# and the 9 orientation entries (featMatchMultiple.cpp:303-318)
_MATCH_LINE = "%s\t%f\t%f\t%f\t%f\timg2_match%4.4d_feat%6.6d\t%f" + "\t%f" * 9 + "\n"


def write_match_file(path, header, name, feats, rows, other, use_native=True):
    """One match file: header, then a line per match m of feats' row
    rows[m], tagged with m and the other image's row other[m]. Through the
    native library (``io.native.write_match_text``), or with
    use_native=False formatted from ``.tolist()`` rows into one string:
    the same bytes."""
    if use_native:
        native.write_match_text(path, header, name, feats.xyz[rows], feats.scale[rows], feats.ori[rows], other)
        return
    geom = np.concatenate([feats.xyz[rows], feats.scale[rows, None]], axis=1).tolist()
    ori = feats.ori[rows].reshape(-1, 9).tolist()
    with open(path, "wt") as f:
        f.write(header + "".join(_MATCH_LINE % (name, *g, m, j, 0.0, *o)
                                 for m, (g, j, o) in enumerate(zip(geom, other.tolist(), ori))))


def write_pair_files(name1, name, f1, f2, res, out_report, timer=None):
    """One pair's output files (featMatchMultiple.cpp:297-330): the inlier
    matches' info flags (formatted from ``.tolist()`` rows into one string)
    and both match files through the native writer (timer stage
    write_matches), the transform and its inverse, the report line
    (appended) and the query set as ``{name}.update.key`` through the
    native writer (write_key)."""
    timer = timer or TRACER
    ts = res.transform
    inl = np.nonzero(res.inlier)[0]
    i1, i2 = res.input_idx[inl], res.model_idx[inl]
    with timer.stage("write_matches"):
        with open(f"{name}.matches.info.txt", "wt") as f:
            # per inlier match: info flags of both features
            # (featMatchMultiple.cpp:301-302, 319)
            f.write("".join(f"{a}\t{b}\n" for a, b in zip(f1.info[i1].tolist(), f2.info[i2].tolist())))
        for tag, line_name, feats, rows, other, fmt in (
            ("img1", name1, f1, i1, i2, "Img1 x1 y1 z1 s1 MatchIndexImg2"),
            ("img2", name, f2, i2, i1, "Img2 x2 y2 z2 s2 MatchIndexImg1"),
        ):
            header = f"# Img1: {name1}\n# Img2: {name}\n# Matches: {len(inl)}\n# Format: {fmt} DistSqr\n"
            write_match_file(f"{name}.matches.{tag}.txt", header, line_name, feats, rows, other)
    ts.write_matrix(f"{name}.trans.txt")
    ts.inverse().write_matrix(f"{name}.trans-inverse.txt")
    print(f"{name}: inliers {res.num_inliers}\t0\t0\t{ts.scale:f}")
    with open(out_report, "a+") as f:
        f.write("%s:\tinliers\t%d\t%d\t%d\t%f\t%f\t%f\t%f\n" % (name, res.num_inliers, 0, 0, ts.scale, *ts.trans))
    with timer.stage("write_key"):
        keyfile.write_text(f2, f"{name}.update.key")


def main(argv=None, device=None, timer=None, mesh=None) -> int:
    """Run the CLI. device: where to match; None means cuda:<N> from -d<N>
    (cuda:0 without it), and raises when there is no CUDA card. Passing a
    device (such as "cpu", the kernels' plain versions) is for callers that
    hold the port against another implementation. timer: what opens the
    spans read, ratio_match, hough, write (the per-pair output files;
    within it write_key, the .update.key files, and write_matches, the
    match files) and group_vote (``utils.timing``; None: the process's
    tracer, which also opens the spans inside them). mesh: the devices
    --shard-match shards over; None means every CUDA card (with
    device="cpu": the CPU alone)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        return -1

    with open("_command.txt", "wt") as f:
        f.write("featmatch " + " ".join(argv) + " \n")

    report = "report.txt"
    only_reoriented = True
    peaks_mode = 4
    neighbors = 5
    file_list = None
    all_to_all = False
    refine = False
    geometry_weight = -1.0
    shard_match = False
    index = 0
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a in ("-o", "-O"):
            i += 1
            report = argv[i]
        elif a.startswith("-s") or a.startswith("-S"):
            peaks_mode = int(a[2:])
        elif a.startswith("-r") or a.startswith("-R"):
            only_reoriented = a[2:3] != "-"
        elif a in ("-n", "-N"):
            i += 1
            neighbors = int(argv[i])
        elif a in ("-f", "-F"):
            i += 1
            file_list = argv[i]
        elif a.startswith("-d") and a[2:].isdigit():
            index = int(a[2:])
        elif a == "--all-to-all":
            all_to_all = True
        elif a == "--shard-match":
            # shard the group-vote kNN over the cards: the mesh analogue of
            # the reference's OpenMP image chunks (featMatchMultiple.cpp:9,108-117)
            shard_match = True
        elif a == "--refine":
            refine = True
        elif a in ("-g", "-G"):
            # geometry-augmented descriptors for group voting: xyz*weight
            # appended to the 64-d descriptors (the reference builds the
            # 67-d FLANN database at featMatchUtilities.cpp:1437-1442,
            # 1530-1539 but never parses a flag for it — exposed here)
            i += 1
            geometry_weight = float(argv[i])
        else:
            print(f"Error: unknown command line argument: {a}")
            return -1
        i += 1

    if shard_match and not all_to_all:
        # sharding applies to the group-vote kNN sweep only; say so
        # instead of silently running the pairwise path unsharded
        print(
            "Warning: --shard-match only affects --all-to-all group "
            "matching; pairwise matching runs unsharded."
        )

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "featmatch-torch runs on a CUDA card and found none; the JAX package's CLI "
                "(python -m sift3d.cli.featmatch) runs on other devices"
            )
        device = f"cuda:{index}"
    dev = resolve_device(device)
    timer = timer or TRACER

    names = read_lines(file_list) if file_list else argv[i:]
    labels = list(range(len(names)))

    with open("_names.txt", "wt") as f:
        for n, l in zip(names, labels):
            f.write(f"{n}\t{l}\n")

    cfg = dataclasses.replace(DEFAULT_CONFIG, knn_neighbors=neighbors)

    sets = []
    total = 0
    feat_type = "Peak and Valley"
    split_sets = ([], []) if peaks_mode == 2 else None
    with timer.stage("read"):
        for n in names:
            print(f"Reading file: {n}...", end="")
            feats, _ = keyfile.read_text(n, eig_threshold=cfg.eig_threshold)
            if only_reoriented:
                feats = feats.remove_non_reoriented()
            else:
                feats = feats.remove_reoriented()
            if peaks_mode == 0:
                feats = feats.remove_non_peak()
                feat_type = "Peaks"
            elif peaks_mode == 1:
                feats = feats.remove_non_valley()
                feat_type = "Valley"
            elif peaks_mode == 2:
                split_sets[0].append(feats.remove_non_valley())
                split_sets[1].append(feats.remove_non_peak())
            sets.append(feats)
            total += len(feats)
            print(f"feats: {len(feats)}, total: {total}")

    with open("feature_count.txt", "wt") as f:
        for j, s in enumerate(sets):
            f.write(f"{j}\t{len(s)}\n")

    open(report, "wt").close()
    match_all_to_one(names, sets, report, cfg, refine, dev, timer)
    if peaks_mode == 2:
        match_all_to_one(names, split_sets[0], report, cfg, refine, dev, timer)
        match_all_to_one(names, split_sets[1], report, cfg, refine, dev, timer)

    if all_to_all:
        # empty per-match debug log, created when the search structure is
        # built in the reference (featMatchUtilities.cpp:1561)
        groupvote.touch_report_all()
        if shard_match and mesh is None:
            mesh = make_mesh() if dev.type == "cuda" else [dev]

        def group_vote(feature_sets):
            # sharded: the kNN over the mesh, the vote on mesh[0]
            if shard_match:
                return groupvote.GroupMatcher(feature_sets, labels, geometry_weight, cfg, mesh=mesh)
            return groupvote.GroupMatcher(feature_sets, labels, geometry_weight, cfg, dev)

        with timer.stage("group_vote"):
            res = group_vote(sets).match_all_to_all()
        groupvote.write_vote_files(res, tag=feat_type)
        if peaks_mode == 2:
            for tag, ss in (("Valley", split_sets[0]), ("Peaks", split_sets[1])):
                with timer.stage("group_vote"):
                    res = group_vote(ss).match_all_to_all()
                groupvote.write_vote_files(res, tag=tag, append=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
