"""Similarity transforms: the TransformSimilarity equivalent.

Port of feat_common/featMatchUtilities.h:152-295 (scale + 3x3 rotation +
translation container with composition, inversion and the 4-line text
matrix format) plus similarity_transform_invert / _3point
(MultiScale.cpp:3056-3117). The port's numpy float64 copy of
``sift3d.match.register``: the same arithmetic, so the transform files it
writes are byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SimilarityTransform:
    scale: float = 1.0
    rot: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3, dtype=np.float64))
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, dtype=np.float64))

    def apply(self, pts: np.ndarray) -> np.ndarray:
        """p' = scale * R @ p + t for [N, 3] points."""
        return self.scale * (np.asarray(pts) @ self.rot.T) + self.trans

    def compose_left(self, left: "SimilarityTransform") -> "SimilarityTransform":
        """self' = left o self (TransformSimilarity::Multiply)."""
        return SimilarityTransform(
            scale=left.scale * self.scale,
            rot=left.rot @ self.rot,
            trans=left.scale * (left.rot @ self.trans) + left.trans,
        )

    def inverse(self) -> "SimilarityTransform":
        inv_rot = self.rot.T
        inv_scale = 1.0 / self.scale
        inv_trans = -inv_scale * (inv_rot @ self.trans)
        return SimilarityTransform(scale=inv_scale, rot=inv_rot, trans=inv_trans)

    def as_mat44(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.scale * self.rot
        m[:3, 3] = self.trans
        return m

    # ---- text IO (TransformSimilarity::WriteMatrix/ReadMatrix) ----
    def write_matrix(self, path: str) -> None:
        with open(path, "wt") as f:
            for r in range(3):
                for c in range(3):
                    f.write("%f\t" % (self.scale * self.rot[r, c]))
                f.write("%f\n" % self.trans[r])
            f.write("0.0\t0.0\t0.0\t1.0\n")

    @staticmethod
    def read_matrix(path: str) -> "SimilarityTransform":
        rows = []
        with open(path, "rt") as f:
            for _ in range(3):
                rows.append([float(v) for v in f.readline().split()])
        m = np.asarray(rows, dtype=np.float64)
        rot = m[:, :3]
        # normalize columns, scale = mean column norm (ReadMatrix semantics)
        norms = np.linalg.norm(rot, axis=0)
        if (norms <= 0).any():
            raise ValueError(f"{path}: degenerate rotation")
        return SimilarityTransform(
            scale=float(norms.mean()), rot=rot / norms[None, :], trans=m[:, 3].copy()
        )
