"""Group-wise soft-vote matching (the matchAllToAll path).

Port of msNearestNeighborApproximateInit / SearchSelf
(feat_common/featMatchUtilities.cpp:1428-1819) and matchAllToAll
(featMatchMultiple/featMatchMultiple.cpp:17-145), the counterpart of
``sift3d.match.groupvote``: FLANN's approximate kd-tree is replaced by the
exact kNN of the kernel M1 over the whole database, and the reference's
OpenMP image chunks by one batched vote over every query.

Semantics replicated (with the snapshot's index/weight pairing bug fixed to
its evident intent, SURVEY.md section 3.4):

- optional geometry concatenation: descriptor ++ weight * xyz / scale
  (:1437-1442, 1530-1539)
- label prior with add-one smoothing (:1486-1497), leave-one-image-out
  adjustment during each image's search (:1597-1599)
- per query: up to k neighbors from *other* images, at most one per target
  image, in ascending distance order (:1647-1669)
- appearance weights exp(-(d/d_min)^2) on squared-L2 distances, d_min =
  first non-zero accepted distance (:1697-1705)
- SoftMax-log normalization: w /= sum w; w = log(w + eta)/log(eta + 1)
  (:1721-1730)
- best-vote-wins dedup per database feature within a query image; vote
  counts increment only on first vote (:1764-1786)
- per-label log-likelihood accumulation (:1798-1809)

The vote runs in f64 on the kNN's device. The JAX package's np.unique
dedup becomes a sort and a segment max (exact in any order); its
``np.add.at`` sums become :func:`segment_sum`, a tree sum over each
segment in ascending order, the same on every device, with no float
atomics; the row sums over k neighbours and over labels keep numpy's
pairwise order (``numerics.numpy_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.core.numerics import numpy_sum, tree_sum
from sift3d_torch.dist.gather import sharded_knn
from sift3d_torch.match.knn import knn_search


@dataclasses.dataclass
class GroupVoteResult:
    votes: np.ndarray  # [n_img, n_labels] summed soft-vote weights
    counts: np.ndarray  # [n_img, n_labels] distinct voted db features
    log_likelihood: np.ndarray  # [n_img, n_labels]


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """[n_seg, ...] sums of values [n, ...] by segment id seg [n]: the
    members of each segment, in their order in `values`, zero-padded to
    the longest segment and added in ``tree_sum``'s order."""
    out_shape = (n_seg,) + tuple(values.shape[1:])
    if values.shape[0] == 0:
        return torch.zeros(out_shape, dtype=values.dtype, device=values.device)
    order = torch.sort(seg, stable=True).indices
    seg_sorted = seg[order]
    sizes = torch.bincount(seg, minlength=n_seg)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(seg.shape[0], device=seg.device) - starts[seg_sorted]
    padded = torch.zeros((n_seg, int(sizes.max())) + tuple(values.shape[1:]), dtype=values.dtype,
                         device=values.device)
    padded[seg_sorted, pos] = values[order]
    return tree_sum(padded.movedim(1, -1))


class GroupMatcher:
    """Concatenated-descriptor database over all images. device: None
    means the card (raises without one); "cpu" runs M1's plain version and
    the vote on the CPU. mesh: an ordered list of devices over which
    :meth:`match_all_to_all` shards the kNN's queries
    (``dist.gather.sharded_knn``, the JAX package's ``--shard-match``); the
    vote then runs on ``mesh[0]``, and the result equals the unsharded one
    bit for bit."""

    def __init__(
        self,
        feature_sets: Sequence[FeatureSet],
        labels: Optional[Sequence[int]] = None,
        geometry_weight: float = -1.0,
        cfg: SiftConfig = DEFAULT_CONFIG,
        device=None,
        mesh: Optional[Sequence] = None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh[0] if mesh is not None else device)
        if mesh is not None and device is not None and resolve_device(device) != self.device:
            raise ValueError(f"with a mesh the vote runs on mesh[0] ({self.device}), not on {device}")
        self.n_img = len(feature_sets)
        self.labels = np.asarray(
            labels if labels is not None else np.arange(self.n_img), dtype=np.int64
        )
        self.n_labels = int(self.labels.max()) + 1 if self.n_img else 0

        descs, feat_img, feat_label = [], [], []
        for i, fs in enumerate(feature_sets):
            d = fs.desc.astype(np.float32).copy()
            if geometry_weight > 0:
                # geometry replaces the first 3 descriptor dims in the
                # reference (:1530-1539); the JAX package appends instead
                # (the intent is extra geometry dimensions; appending keeps
                # appearance)
                g = geometry_weight * fs.xyz / fs.scale[:, None]
                d = np.concatenate([d, g.astype(np.float32)], axis=1)
            descs.append(d)
            feat_img.append(np.full(len(fs), i, np.int64))
            feat_label.append(np.full(len(fs), self.labels[i], np.int64))
        self.db = np.concatenate(descs) if descs else np.zeros((0, 64), np.float32)
        self.feat_img = np.concatenate(feat_img) if feat_img else np.zeros(0, np.int64)
        self.feat_label = np.concatenate(feat_label) if feat_label else np.zeros(0, np.int64)
        self.img_start = np.zeros(self.n_img + 1, np.int64)
        for i, fs in enumerate(feature_sets):
            self.img_start[i + 1] = self.img_start[i] + len(fs)

        # label prior with add-one smoothing (:1486-1497)
        counts = np.bincount(self.feat_label, minlength=self.n_labels).astype(np.float64)
        counts += 1.0
        self.label_prior = counts / counts.sum()
        self.total_prior_denom = float(len(self.feat_img) + self.n_labels)

    def knn(self, k: int):
        """(dist, idx) of every database row's k nearest rows, on the device
        (with a mesh: the queries sharded over it)."""
        if self.mesh is not None:
            return sharded_knn(self.db, self.db, k, self.mesh)
        return knn_search(self.db, self.db, k, self.device)

    def _vote_all(self, dist: torch.Tensor, idx: torch.Tensor, q_img: torch.Tensor):
        """Batched SearchSelf over an arbitrary mixed-image query set:
        dist [Q, k] f64, idx [Q, k] and q_img [Q] int64, on the device.

        Segment reductions keyed on the query's image; semantics identical
        to `_search_image_loop` (oracle-tested): the per-(query-image)
        best-vote dedup is a sort and a segment max over combined (query
        image, db feature) keys, the leave-one-image-out prior a [n_img,
        n_labels] table indexed per query.

        Returns (votes, counts, ll), each [n_img, n_labels] on the device;
        images with no queries in `q_img` get zero rows.
        """
        cfg, dev = self.cfg, dist.device
        n_img, n_labels = self.n_img, self.n_labels
        n_feat = len(self.feat_img)
        votes = torch.zeros((n_img, n_labels), dtype=torch.float64, device=dev)
        counts = torch.zeros((n_img, n_labels), dtype=torch.int64, device=dev)
        ll = torch.zeros((n_img, n_labels), dtype=torch.float64, device=dev)
        q, k = idx.shape
        if q == 0 or k == 0:
            return votes, counts, ll

        feat_img = torch.as_tensor(self.feat_img, device=dev)
        feat_label = torch.as_tensor(self.feat_label, device=dev)
        img = feat_img[idx]  # [Q, k]
        lab = feat_label[idx]
        # one vote per target image, ascending-distance order: j is accepted
        # iff its image is not the query's and no earlier j' hits the same
        # image (the first of each other image is accepted)
        earlier = torch.ones((k, k), dtype=torch.bool, device=dev).tril(-1)
        dup = ((img[:, :, None] == img[:, None, :]) & earlier).any(dim=2)
        acc = (img != q_img[:, None]) & ~dup

        inf = torch.full_like(dist, torch.inf)
        min_dist = torch.where(acc & (dist > 0), dist, inf).amin(dim=1)
        min_dist = torch.where(torch.isfinite(min_dist), min_dist, torch.ones_like(min_dist))  # (:1697)

        r = dist / min_dist[:, None]
        zero = torch.zeros_like(dist)
        w = torch.where(acc, torch.exp(-(r * r)), zero)
        sw = numpy_sum(w)
        ok = sw > 0
        wn = torch.where(
            ok[:, None],
            torch.log(w / torch.where(ok, sw, torch.ones_like(sw))[:, None] + cfg.softvote_eta)
            / float(np.log(cfg.softvote_eta + 1.0)),
            zero,
        )

        # leave-one-image-out priors, one row per query image (:1597-1599)
        n_per_img = (self.img_start[1:] - self.img_start[:-1]).astype(np.float64)
        priors = np.tile(self.label_prior, (n_img, 1))
        np.subtract.at(priors, (np.arange(n_img), self.labels), n_per_img / self.total_prior_denom)
        priors = torch.as_tensor(priors, device=dev)

        use = acc & ok[:, None]
        fi = idx[use]
        wv = wn[use]
        qi = q_img[:, None].expand(q, k)[use]
        if fi.numel():
            # best-vote-wins dedup per (query image, db feature) (:1764-1786)
            uniq, inv = torch.unique(qi * n_feat + fi, sorted=True, return_inverse=True)
            maxw = torch.full(uniq.shape, -torch.inf, dtype=torch.float64, device=dev)
            maxw.scatter_reduce_(0, inv, wv, reduce="amax")
            seg = (uniq // n_feat) * n_labels + feat_label[uniq % n_feat]
            votes = segment_sum(maxw, seg, n_img * n_labels).reshape(n_img, n_labels)
            counts = torch.bincount(seg, minlength=n_img * n_labels).reshape(n_img, n_labels)

        # per-query label log-likelihood (:1767-1809)
        qsel = torch.nonzero(ok)[:, 0]
        if qsel.numel():
            p_q = priors[q_img]  # [Q, n_labels]
            expo = dist / (min_dist[:, None] + 1.0)
            contrib = torch.where(use, torch.exp(-(expo * expo)), zero) / p_q.gather(1, lab)
            lcounts = p_q[qsel]
            lab_s, contrib_s = lab[qsel], contrib[qsel]
            for j in range(k):  # np.add.at's order: each row's neighbours in turn
                at = lab_s[:, j : j + 1]
                lcounts.scatter_(1, at, lcounts.gather(1, at) + contrib_s[:, j : j + 1])
            ll_rows = torch.log(lcounts / numpy_sum(lcounts)[:, None])
            ll = segment_sum(ll_rows, q_img[qsel], n_img)

        return votes, counts, ll

    def _search_image_loop(self, img_idx: int, knn_dists=None, knn_idx=None) -> GroupVoteResult:
        """Line-by-line port of msNearestNeighborApproximateSearchSelf (oracle)."""
        cfg = self.cfg
        k = min(cfg.knn_neighbors, len(self.feat_img))
        lo, hi = int(self.img_start[img_idx]), int(self.img_start[img_idx + 1])
        if knn_dists is None:
            d, i = knn_search(self.db[lo:hi], self.db, k, self.device)
            knn_dists, knn_idx = d.cpu().numpy(), i.cpu().numpy()

        # leave-one-image-out prior adjustment (:1597-1599)
        img_label = int(self.labels[img_idx])
        prior = self.label_prior.copy()
        prior[img_label] -= (hi - lo) / self.total_prior_denom

        votes = np.zeros(self.n_labels, np.float64)
        counts = np.zeros(self.n_labels, np.int64)
        ll = np.zeros(self.n_labels, np.float64)
        voted: dict = {}  # db feature -> (best weight, label)

        for qi in range(hi - lo):
            res_idx = knn_idx[qi]
            res_dist = knn_dists[qi]
            accepted: List[int] = []
            acc_dist: List[float] = []
            seen_imgs = set()
            min_dist = -1.0
            for j in range(min(k, len(res_idx))):
                fi = int(res_idx[j])
                im = int(self.feat_img[fi])
                if im == img_idx:
                    continue  # own image excluded (:1654)
                if im in seen_imgs:
                    continue  # one vote per target image (:1659-1663)
                accepted.append(fi)
                dj = float(res_dist[j])
                acc_dist.append(dj)
                if dj > 0 and (min_dist < 0 or dj < min_dist):
                    min_dist = dj
                seen_imgs.add(im)
            if not accepted:
                continue

            w = np.asarray(acc_dist, np.float64)
            if min_dist <= 0:
                min_dist = 1.0
            w = np.exp(-((w / min_dist) ** 2))
            sw = w.sum()
            if sw <= 0:
                continue  # (:1746-1748)
            w = np.log(w / sw + cfg.softvote_eta) / np.log(cfg.softvote_eta + 1.0)

            # per-query label-likelihood accumulation (:1767-1809)
            lcounts = prior.copy()
            for j, fi in enumerate(accepted):
                lab = int(self.feat_label[fi])
                expo = acc_dist[j] / (min_dist + 1.0)
                lcounts[lab] += np.exp(-expo * expo) / prior[lab]

                # best-vote dedup per db feature (:1764-1786)
                prev = voted.get(fi)
                if prev is not None:
                    if w[j] > prev:
                        if prev > 0:
                            votes[lab] -= prev
                        votes[lab] += w[j]
                        voted[fi] = w[j]
                else:
                    votes[lab] += w[j]
                    counts[lab] += 1
                    voted[fi] = w[j]
            ll += np.log(lcounts / lcounts.sum())

        return GroupVoteResult(votes=votes[None], counts=counts[None], log_likelihood=ll[None])

    def match_all_to_all(self) -> GroupVoteResult:
        """All images vs the database: one kNN launch (M1; with a mesh, one
        per entry), then the vote."""
        k = min(self.cfg.knn_neighbors, len(self.feat_img))
        if k == 0 or not len(self.db):
            z = np.zeros((self.n_img, self.n_labels))
            return GroupVoteResult(z.copy(), z.astype(np.int64), z.copy())
        dist, idx = self.knn(k)
        votes, counts, ll = self._vote_all(
            dist.double(), idx, torch.as_tensor(self.feat_img, device=self.device)
        )
        return GroupVoteResult(votes.cpu().numpy(), counts.cpu().numpy(), ll.cpu().numpy())


def touch_report_all(path: str = "report.all.txt") -> None:
    """Create (truncate) the group matcher's report.all.txt.

    The reference opens this file when the FLANN search structure is
    built (msNearestNeighborApproximateInit, featMatchUtilities.cpp:1561)
    and closes it on Delete (:1569) — no fprintf ever targets it in this
    snapshot, so its on-disk parity artifact is an empty file created at
    group-matcher init (called by the CLI's --all-to-all path)."""
    open(path, "wt").close()


def write_vote_files(
    result: GroupVoteResult,
    votes_path: str = "matching_votes.txt",
    counts_path: str = "vote_count.txt",
    tag: str = "Peak and Valley",
    append: bool = False,
) -> None:
    """matching_votes.txt / vote_count.txt (featMatchMultiple.cpp:119-140)."""
    mode = "at" if append else "wt"
    with open(votes_path, mode) as fv, open(counts_path, mode) as fc:
        fv.write(tag + "\n")
        fc.write(tag + "\n")
        for i in range(result.votes.shape[0]):
            fv.write("".join("%f\t" % v for v in result.votes[i]) + "\n")
            fc.write("".join("%d\t" % c for c in result.counts[i]) + "\n")
        fv.write("\n")
        fc.write("\n")
