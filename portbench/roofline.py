"""Work counts from shapes, and the H100's published peaks.

The peaks and :func:`bound` are a frozen copy of ``chip_smoke.py``'s
(``chip_smoke.py:254-267``): NVIDIA's data sheet for the H100 SXM, dense
rates, at the full 700 W power limit. The counts are of the least work
the algorithm needs, from shapes alone, the same whatever implements it:
every input byte read once and every output byte written once.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense

F32 = 4
INT8 = 1


def bound(n_bytes: float, flops: float, int8_ops: float = 0.0):
    """(least ms the card could take, "bytes" or "operations"): the largest
    of the bytes over the memory rate, the f32 FLOPs over their peak and
    the int8 tensor-core operations over theirs."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, int8_ops / INT8_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def octave_shapes(grid_zyx: Sequence[int]) -> list:
    """The [Z, Y, X] of every octave: halved until a side is 2 or less
    (MultiScale.cpp:359-360)."""
    z, y, x = (int(d) for d in grid_zyx)
    out = []
    while z > 2 and y > 2 and x > 2:
        out.append((z, y, x))
        z, y, x = z // 2, y // 2, x // 2
    return out


def pyramid_bytes(grid_zyx: Sequence[int], batch: int, levels_per_octave: int = 3) -> float:
    """Least bytes of a batch's pyramid: the initial blur; per octave the
    blurs of levels 1..s+2, the DoG and extrema pass (s+3 levels read, s+2
    DoGs written in f32 and s extrema planes in int8) and the 2x subsample
    of level s (read, and the next base written)."""
    s = levels_per_octave
    n_levels, n_dogs = s + 3, s + 2
    total = 0.0
    for i, (z, y, x) in enumerate(octave_shapes(grid_zyx)):
        v = z * y * x
        if i == 0:
            total += 2 * v * F32  # initial blur
        total += (n_levels - 1) * 2 * v * F32  # blurs of levels 1..s+2
        total += (n_levels + n_dogs) * v * F32 + s * v * INT8  # DoGs + extrema
        total += v * F32 + (z // 2) * (y // 2) * (x // 2) * F32  # subsample
    return batch * total


def knn_int8_ops(rows: int, columns: int = 64) -> float:
    """int8 tensor-core operations of an all-to-all kNN over `rows` rows:
    one multiply and one add for each column of each pair."""
    return 2.0 * rows * rows * columns
