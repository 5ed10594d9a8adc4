"""The reference's own .key text parser.

Reads the rows the benchmark's traffic writes (``traffic/keysets``): a
header of '#' lines, 'Features: N', the legend, then N rows of 16 floats
(x y z scale, 9 orientation entries, 3 eigenvalues), the info flag and 64
descriptor integers. The floats are "%f" decimals; parsing each to f64
and rounding to f32 gives the f32 nearest the decimal (a six-decimal
number never lies within an f64 rounding of an f32 midpoint that it does
not equal), as strtof does.
"""

from __future__ import annotations

import numpy as np


def read_key(path: str) -> dict:
    """{xyz [N,3], scale [N], ori [N,3,3], eigs [N,3]} f32, info [N]
    uint32, desc [N,64] f32."""
    with open(path, "rt") as f:
        lines = f.read().split("\n")
    i = 0
    while lines[i].startswith("#"):
        i += 1
    if not lines[i].startswith("Features:"):
        raise ValueError(f"{path}: missing 'Features:' line")
    n = int(lines[i].split(":", 1)[1])
    rows = lines[i + 2 : i + 2 + n]
    if len(rows) != n:
        raise ValueError(f"{path}: {len(rows)} rows, {n} declared")
    fields = np.array([r.split() for r in rows], dtype=object).reshape(n, 81) if n else np.zeros((0, 81), object)
    floats = fields[:, :16].astype(np.float64).astype(np.float32)
    ints = fields[:, 16:].astype(np.int64)
    return dict(
        xyz=floats[:, 0:3].copy(),
        scale=floats[:, 3].copy(),
        ori=floats[:, 4:13].reshape(n, 3, 3).copy(),
        eigs=floats[:, 13:16].copy(),
        info=ints[:, 0].astype(np.uint32),
        desc=ints[:, 1:].astype(np.float32),
    )
