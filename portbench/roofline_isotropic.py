"""Work counts of featExtract's -w path from shapes, in ``roofline.py``'s
way: the least bytes the algorithm needs, every input byte read once and
every output byte written once, the same whatever implements it."""

from __future__ import annotations

import math
from typing import Sequence

import roofline


def resample_bytes(grid_zyx: Sequence[int], extraction_grid_zyx: Sequence[int], volumes: int) -> float:
    """The resampling of `volumes` f32 volumes of grid_zyx to
    extraction_grid_zyx: each input voxel read once (4 bytes), each output
    voxel written once (4 bytes)."""
    v_in = math.prod(int(n) for n in grid_zyx)
    v_out = math.prod(int(n) for n in extraction_grid_zyx)
    return volumes * roofline.F32 * (v_in + v_out)
