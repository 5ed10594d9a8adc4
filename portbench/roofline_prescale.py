"""Work counts of featExtract's -2+ path from shapes, in ``roofline.py``'s
way: the least bytes the algorithm needs, every input byte read once and
every output byte written once, the same whatever implements it."""

from __future__ import annotations

import math
from typing import Sequence

import roofline


def upsample_bytes(grid_zyx: Sequence[int], volumes: int) -> float:
    """The doubling of `volumes` f32 volumes of grid_zyx (every axis longer
    than 1): each input voxel read once (4 bytes), each of its 8 output
    voxels written once (32 bytes)."""
    v = math.prod(int(n) for n in grid_zyx)
    return volumes * (roofline.F32 * v + 8 * roofline.F32 * v)


def prescaled_pyramid_bytes(config: dict, volumes: int) -> float:
    """``roofline.pyramid_bytes`` of the grid the configuration extracts
    at (``extraction_grid_zyx``, the doubled grid), not of its input grid."""
    return roofline.pyramid_bytes(config["extraction_grid_zyx"], volumes)
