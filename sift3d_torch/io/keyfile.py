""".key feature file IO — byte-compatible with the reference text format.

Format (writer msFeature3DVectorOutputText, src_common/MultiScale.h:386-474;
reader msFeature3DVectorInputText, MultiScale.h:305-384):

    # featExtract 1.1
    # <optional comment lines>
    Features: N
    Scale-space location[x y z scale] orientation[o11 ... o32] 2nd moment
        eigenvalues[e1 e2 e3] info flag[i1] descriptor[d1 .. d64]
    x<TAB>y<TAB>z<TAB>scale<TAB>o11..o33<TAB>e1 e2 e3<TAB>info<TAB>d1..d64<TAB>\n

Floats print as C "%f" (6 decimals); descriptor values print as
(char)-cast integers (after rank normalization they are 0..63). The
eigenvalue threshold is re-applied at write time (MultiScale.h:407-414).

The PyTorch port's copy of the text half of ``sift3d.io.keyfile``: the
pure-Python writer and reader (the JAX package's optional C++ fast path
writes the same bytes; its binary variant is not carried over).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sift3d_torch.core.featureset import DESCRIPTOR_SIZE, FeatureSet

HEADER_LINE = "# featExtract 1.1"
LEGEND_LINE = (
    "Scale-space location[x y z scale] orientation[o11 o12 o13 o21 o22 o23 o31 o32 o32] "
    "2nd moment eigenvalues[e1 e2 e3] info flag[i1] descriptor[d1 .. d64]"
)


def _fmt(v: float) -> str:
    return "%f" % float(v)


def write_text(
    feats: FeatureSet,
    path: str,
    eig_threshold: float = -1.0,
    comments: Optional[Sequence[str]] = None,
) -> int:
    """Write features; returns the number written after eig filtering."""
    keep = feats.eig_mask(eig_threshold)
    idx = np.nonzero(keep)[0]
    lines: List[str] = [HEADER_LINE]
    for c in comments or []:
        lines.append("# " + c)
    lines.append("Features: %d" % len(idx))
    lines.append(LEGEND_LINE)
    for i in idx:
        parts = [_fmt(feats.xyz[i, 0]), _fmt(feats.xyz[i, 1]), _fmt(feats.xyz[i, 2]), _fmt(feats.scale[i])]
        parts += [_fmt(feats.ori[i, r, c]) for r in range(3) for c in range(3)]
        parts += [_fmt(feats.eigs[i, j]) for j in range(3)]
        parts.append(str(int(feats.info[i])))
        # (char) cast of the float descriptor value (MultiScale.h:467):
        # truncation toward zero then wrap to signed 8-bit.
        desc_int = feats.desc[i].astype(np.int64)
        desc_int = ((desc_int + 128) % 256) - 128
        parts += [str(int(v)) for v in desc_int]
        lines.append("\t".join(parts) + "\t")
    with open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return len(idx)


def read_text(path: str, eig_threshold: float = -1.0) -> Tuple[FeatureSet, List[str]]:
    """Read a .key text file; returns (features, comment lines).

    Like the reference reader, comment lines are skipped and the feature
    count line is parsed; unlike the reference we also return comments so
    callers can inspect the coordinate-space header. The eig threshold is
    applied after reading (featMatchMultiple.cpp:596 passes 140 -- note the
    reference reader accepts it but applies no filter; we apply it to honor
    the intent; pass -1 for raw reads).
    """
    comments: List[str] = []
    with open(path, "rt") as f:
        line = f.readline()
        while line.startswith("#"):
            comments.append(line[1:].strip())
            line = f.readline()
        if not line.startswith("Features:"):
            raise ValueError(f"{path}: missing 'Features:' line")
        n = int(line.split(":", 1)[1])
        legend = f.readline()
        if "Scale-space location[x y z scale]" not in legend:
            raise ValueError(f"{path}: missing legend line")
        data = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
    if data.size == 0:
        return FeatureSet.empty(0), comments
    if data.shape[1] != 4 + 9 + 3 + 1 + DESCRIPTOR_SIZE:
        raise ValueError(f"{path}: unexpected column count {data.shape[1]}")
    feats = FeatureSet(
        xyz=data[:, 0:3].astype(np.float32),
        scale=data[:, 3].astype(np.float32),
        ori=data[:, 4:13].reshape(-1, 3, 3).astype(np.float32),
        eigs=data[:, 13:16].astype(np.float32),
        info=data[:, 16].astype(np.uint32),
        desc=data[:, 17:].astype(np.float32),
    )
    if eig_threshold >= 0:
        feats = feats.apply_eig_threshold(eig_threshold)
    return feats, comments
