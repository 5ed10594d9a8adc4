"""PGM debug slice writer (the CLI's --debug-pgm).

The port's copy of ``sift3d.utils.pgm``, on the port's pyramid: the
successor of PpImageFloatOutput::output_float
(src_common/PpImageFloatOutput.h:19-24), which normalizes a float 2D slice
to 8 bits and writes a binary PGM, used for eyeballing blur correctness
(MultiScale.cpp:305-313). The CLI writes the input's mid slice and, from
the pyramid it extracts from, each octave's first blur level.
"""

from __future__ import annotations

import numpy as np
import torch


def write_pgm(path: str, img) -> None:
    """Write a 2D array as an 8-bit binary PGM, min..max scaled to 0..255."""
    img = np.asarray(img, dtype=np.float64)
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    data = ((img - lo) * scale).astype(np.uint8)
    h, w = data.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def write_volume_slice(path: str, vol: torch.Tensor, z: int | None = None) -> None:
    """Write the middle (or given) XY slice of a [Z, Y, X] volume."""
    if z is None:
        z = vol.shape[0] // 2
    write_pgm(path, vol[z].cpu().numpy())

