"""FeatureSet: structure-of-arrays successor of vector<Feature3DInfo>.

The reference models features as an array-of-structs
(src_common/MultiScale.h:42-164: location, scale, 3x3 orientation, 3
eigenvalues, info flags, 64 descriptor values). For batched device math a
structure-of-arrays layout is the natural choice; this container is the
host-side pivot between device pipelines and the .key file format. It is
the PyTorch port's numpy-only copy of ``sift3d.core.featureset``.

Info flag bits (MultiScale.h:28-34):
  INFO_FLAG_MIN0MAX1 = 0x10  (0 = valley/minimum, 1 = peak/maximum)
  INFO_FLAG_REORIENT = 0x20  (1 = appearance reoriented)
  INFO_FLAG_LINE     = 0x100 (line feature; ori holds a second point)
"""

from __future__ import annotations

import dataclasses

import numpy as np

INFO_FLAG_MIN0MAX1 = 0x00000010
INFO_FLAG_REORIENT = 0x00000020
INFO_FLAG_LINE = 0x00000100

DESCRIPTOR_SIZE = 64


@dataclasses.dataclass
class FeatureSet:
    """N features as parallel numpy arrays."""

    xyz: np.ndarray  # [N, 3] float32 (x, y, z)
    scale: np.ndarray  # [N] float32
    ori: np.ndarray  # [N, 3, 3] float32
    eigs: np.ndarray  # [N, 3] float32
    info: np.ndarray  # [N] uint32
    desc: np.ndarray  # [N, 64] float32

    def __len__(self) -> int:
        return int(self.xyz.shape[0])

    @staticmethod
    def empty(n: int = 0) -> "FeatureSet":
        return FeatureSet(
            xyz=np.zeros((n, 3), np.float32),
            scale=np.zeros((n,), np.float32),
            ori=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
            eigs=np.zeros((n, 3), np.float32),
            info=np.zeros((n,), np.uint32),
            desc=np.zeros((n, DESCRIPTOR_SIZE), np.float32),
        )

    def select(self, mask_or_idx) -> "FeatureSet":
        return FeatureSet(
            xyz=self.xyz[mask_or_idx],
            scale=self.scale[mask_or_idx],
            ori=self.ori[mask_or_idx],
            eigs=self.eigs[mask_or_idx],
            info=self.info[mask_or_idx],
            desc=self.desc[mask_or_idx],
        )

    @staticmethod
    def concatenate(sets) -> "FeatureSet":
        sets = list(sets)
        if not sets:
            return FeatureSet.empty(0)
        return FeatureSet(
            xyz=np.concatenate([s.xyz for s in sets]),
            scale=np.concatenate([s.scale for s in sets]),
            ori=np.concatenate([s.ori for s in sets]),
            eigs=np.concatenate([s.eigs for s in sets]),
            info=np.concatenate([s.info for s in sets]),
            desc=np.concatenate([s.desc for s in sets]),
        )

    # ---- flag helpers ----
    @property
    def is_peak(self) -> np.ndarray:
        return (self.info & INFO_FLAG_MIN0MAX1) != 0

    @property
    def is_reoriented(self) -> np.ndarray:
        return (self.info & INFO_FLAG_REORIENT) != 0

    # ---- filters (feat_common/featMatchUtilities.cpp:1262-1370) ----
    def remove_non_reoriented(self) -> "FeatureSet":
        return self.select(self.is_reoriented)

    def remove_reoriented(self) -> "FeatureSet":
        """Keep unoriented features, resetting ori to identity
        (featMatchUtilities.cpp:1280-1303)."""
        out = self.select(~self.is_reoriented)
        out.ori = np.tile(np.eye(3, dtype=np.float32), (len(out), 1, 1))
        return out

    def remove_non_peak(self) -> "FeatureSet":
        return self.select(self.is_peak)

    def remove_non_valley(self) -> "FeatureSet":
        return self.select(~self.is_peak)

    def eig_mask(self, eig_threshold: float) -> np.ndarray:
        """(sum λ)^3 < thres * (prod λ), the edge-response keep rule
        (MultiScale.h:407-414); threshold < 0 keeps all."""
        if eig_threshold < 0:
            return np.ones(len(self), dtype=bool)
        s = self.eigs.sum(axis=1)
        p = self.eigs.prod(axis=1)
        return s * s * s < eig_threshold * p

    def apply_eig_threshold(self, eig_threshold: float) -> "FeatureSet":
        return self.select(self.eig_mask(eig_threshold))

    def similarity_transform(self, mat4x4: np.ndarray) -> "FeatureSet":
        """Apply a 4x4 similarity to geometry (Feature3DInfo::SimilarityTransform,
        MultiScale.cpp:87-125): point by the matrix, scale by the mean row
        norm, ori by the normalized rotation applied on the left in
        column-space (ori' = (R @ ori^T)^T)."""
        m = np.asarray(mat4x4, dtype=np.float64).reshape(4, 4)
        pts = np.concatenate([self.xyz, np.ones((len(self), 1), np.float32)], axis=1)
        new_xyz = (pts @ m.T)[:, :3].astype(np.float32)
        row_norms = np.linalg.norm(m[:3, :3], axis=1)
        scale_sum = row_norms.mean()
        rot = m[:3, :3] / row_norms[:, None]
        new_ori = np.einsum("ij,njk->nik", rot, self.ori.transpose(0, 2, 1)).transpose(0, 2, 1)
        return FeatureSet(
            xyz=new_xyz,
            scale=(self.scale * scale_sum).astype(np.float32),
            ori=new_ori.astype(np.float32),
            eigs=self.eigs.copy(),
            info=self.info.copy(),
            desc=self.desc.copy(),
        )
