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

The PyTorch port's copy of ``sift3d.io.keyfile``. The text writer and
reader run through the C++ library of ``sift3d_torch.io.native`` by
default; ``use_native=False`` selects their plain version here, which
writes the same bytes (glibc's "%f", "-nan" for a NaN with its sign bit
set) and reads the same rows (each decimal rounded to f32 once, as strtof
does; at most the declared count, stopping at the first row that does not
parse). A binary variant mirrors msFeature3DVectorOutputBin
(MultiScale.h:228-303).
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sift3d_torch.core.featureset import DESCRIPTOR_SIZE, FeatureSet
from sift3d_torch.io import native
from sift3d_torch.utils.timing import TRACER

HEADER_LINE = "# featExtract 1.1"
LEGEND_LINE = (
    "Scale-space location[x y z scale] orientation[o11 o12 o13 o21 o22 o23 o31 o32 o32] "
    "2nd moment eigenvalues[e1 e2 e3] info flag[i1] descriptor[d1 .. d64]"
)
_FLOATS = 4 + 9 + 3  # x y z scale, orientation, eigenvalues


def write_text(
    feats: FeatureSet,
    path: str,
    eig_threshold: float = -1.0,
    comments: Optional[Sequence[str]] = None,
    use_native: bool = True,
) -> int:
    """Write features; returns the number written after eig filtering.
    use_native=False writes the same bytes in Python."""
    if use_native:
        return native.write_key_text(feats, path, eig_threshold, comments)
    idx = np.nonzero(feats.eig_mask(eig_threshold))[0]
    vals = np.concatenate(
        [feats.xyz[idx], feats.scale[idx, None], feats.ori[idx].reshape(-1, 9), feats.eigs[idx]], axis=1
    )
    # (char) cast of the float descriptor value (MultiScale.h:467):
    # truncation toward zero then wrap to signed 8-bit
    with np.errstate(invalid="ignore"):
        desc_int = ((feats.desc[idx].astype(np.int64) + 128) % 256) - 128
    row_fmt = "%f\t" * _FLOATS + "%d\t" * (1 + DESCRIPTOR_SIZE)
    lines: List[str] = [HEADER_LINE, *("# " + c for c in comments or []), "Features: %d" % len(idx), LEGEND_LINE]
    neg_nan = np.isnan(vals) & np.signbit(vals)
    for v, i, d, nn in zip(vals.tolist(), feats.info[idx].tolist(), desc_int.tolist(), neg_nan.any(axis=1)):
        if nn:  # glibc prints a NaN's sign, Python's "%f" does not
            lines.append("".join("-nan\t" if x != x and np.signbit(x) else "%f\t" % x for x in v)
                         + ("%d\t" * (1 + DESCRIPTOR_SIZE)) % (i, *d))
        else:
            lines.append(row_fmt % (*v, i, *d))
    with open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return len(idx)


# One row as strtof and strtoul scan it: each field skips leading white
# space and takes the longest prefix that is a number, with no backtracking
# (atomic groups), so a field that is not a number ends the row.
_NUM = (
    r"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?"
    r"|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN](?:\([0-9A-Za-z_]*\))?)"
)
_ROW = re.compile(
    (r"\s*+((?>%s))" % _NUM) * _FLOATS + r"\s*+((?>[+-]?\d+))" + (r"\s*+((?>%s))" % _NUM) * DESCRIPTOR_SIZE,
    re.ASCII,  # C's isspace and isdigit
)
_ULONG_MAX = 2**64 - 1


def _to_f64(tok: str) -> float:
    low = tok.lower()
    if "x" in low:
        return float.fromhex(tok)
    if "(" in low:  # nan(chars)
        return float(tok[: tok.index("(")])
    return float(tok)


def _strtof(toks: Sequence[str]) -> np.ndarray:
    """Decimal strings to f32, each rounded once (strtof). The f64 parse is
    exact or rounded once; its f32 rounding differs from a single rounding
    only where the f64 value lies exactly halfway between two f32 values,
    and there the exact decimal decides."""
    d = np.array([_to_f64(t) for t in toks], np.float64)
    with np.errstate(over="ignore"):
        r = d.astype(np.float32)
    r64 = r.astype(np.float64)
    fin = np.isfinite(d) & np.isfinite(r64)
    away = np.where(d > r64, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32)
    nb = np.nextafter(r, away)
    with np.errstate(invalid="ignore"):
        tie = fin & (d != r64) & (d == (r64 + nb.astype(np.float64)) * 0.5)
    for j in np.nonzero(tie)[0]:
        exact = Fraction(toks[j]) if "x" not in toks[j].lower() else Fraction(float.fromhex(toks[j]))
        mid = Fraction(float(d[j]))
        if exact != mid:
            r[j] = nb[j] if (exact > mid) == (float(nb[j]) > float(r[j])) else r[j]
    return r


def _strtoul32(tok: str) -> int:
    v = int(tok)
    return (_ULONG_MAX if abs(v) > _ULONG_MAX else v) & 0xFFFFFFFF


def _read_rows_plain(f, n: int) -> FeatureSet:
    """At most n rows from the open file, as csrc/key_text.cpp's reader takes
    them: a row of 16 floats, an info and 64 descriptor values (anything
    after them ignored); the first row that is not ends the read."""
    rows = []
    for line in f:
        if len(rows) >= n:
            break
        m = _ROW.match(line)
        if m is None:
            break
        rows.append(m.groups())
    k = len(rows)
    floats = _strtof([t for g in rows for t in g[:_FLOATS] + g[_FLOATS + 1 :]]).reshape(k, _FLOATS + DESCRIPTOR_SIZE)
    return FeatureSet(
        xyz=floats[:, 0:3].copy(),
        scale=floats[:, 3].copy(),
        ori=floats[:, 4:13].reshape(-1, 3, 3).copy(),
        eigs=floats[:, 13:16].copy(),
        info=np.array([_strtoul32(g[_FLOATS]) for g in rows], np.uint32),
        desc=floats[:, _FLOATS:].copy(),
    )


def read_text(path: str, eig_threshold: float = -1.0, use_native: bool = True) -> Tuple[FeatureSet, List[str]]:
    """Read a .key text file; returns (features, comment lines).

    Like the reference reader, comment lines are skipped and the feature
    count line is parsed; unlike the reference we also return comments so
    callers can inspect the coordinate-space header. The eig threshold is
    applied after reading (featMatchMultiple.cpp:596 passes 140 -- note the
    reference reader accepts it but applies no filter; we apply it to honor
    the intent; pass -1 for raw reads). use_native=False reads the same rows
    in Python. The rows' parse is the span key_rows (``utils.timing.TRACER``).
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
        with TRACER.stage("key_rows"):
            feats = native.read_key_text(path) if use_native else _read_rows_plain(f, n)
    if eig_threshold >= 0:
        feats = feats.apply_eig_threshold(eig_threshold)
    return feats, comments


_BIN_RECORD = np.dtype(
    [
        ("geom", "<f4", 4),  # x y z scale
        ("ori", "<f4", 9),
        ("eigs", "<f4", 3),
        ("info", "<u4"),
        ("desc", "u1", DESCRIPTOR_SIZE),
    ]
)


def write_binary(feats: FeatureSet, path: str, eig_threshold: float = -1.0) -> int:
    """Binary variant (writer msFeature3DVectorOutputBin, MultiScale.h:228-303):
    text header then packed little-endian records of 16 floats + uint32 + 64
    uint8 descriptor bytes."""
    idx = np.nonzero(feats.eig_mask(eig_threshold))[0]
    recs = np.zeros(len(idx), _BIN_RECORD)
    recs["geom"][:, 0:3] = feats.xyz[idx]
    recs["geom"][:, 3] = feats.scale[idx]
    recs["ori"] = feats.ori[idx].reshape(-1, 9)
    recs["eigs"] = feats.eigs[idx]
    recs["info"] = feats.info[idx]
    with np.errstate(invalid="ignore"):
        recs["desc"] = feats.desc[idx].astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("%s\nFeatures: %d\n" % (HEADER_LINE, len(idx))).encode())
        f.write(recs.tobytes())
    return len(idx)


def read_binary(path: str, eig_threshold: float = -1.0) -> FeatureSet:
    """Read a binary .key file written by write_binary (or the reference's
    msFeature3DVectorOutputBin, MultiScale.h:228-303 — the reference ships
    no binary reader of its own, so this completes the round trip)."""
    with open(path, "rb") as f:
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        if not line.startswith(b"Features:"):
            raise ValueError(f"{path}: missing 'Features:' line")
        n = int(line.split(b":", 1)[1])
        recs = np.frombuffer(f.read(n * _BIN_RECORD.itemsize), dtype=_BIN_RECORD, count=n)
    feats = FeatureSet(
        xyz=recs["geom"][:, 0:3].astype(np.float32),
        scale=recs["geom"][:, 3].astype(np.float32),
        ori=recs["ori"].reshape(-1, 3, 3).astype(np.float32),
        eigs=recs["eigs"].astype(np.float32),
        info=recs["info"].astype(np.uint32),
        desc=recs["desc"].astype(np.float32),
    )
    if eig_threshold >= 0:
        feats = feats.apply_eig_threshold(eig_threshold)
    return feats
