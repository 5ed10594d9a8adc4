"""End-to-end single-volume feature extraction, run eagerly.

PyTorch port of ``sift3d.pipeline.extract.extract_features`` with GoH
descriptors and reoriented copies (the `featextract in.nii out.key` path):

  initial blur -> per octave: Gaussian stack, DoGs + extrema (K1)
               -> candidate table (nonzero + stable sort)
               -> refinement, bounds test, identity patches (K2), eigen test
               -> canonical orientations (K3)
               -> rotated patches (K4), GoH descriptors
               -> rows in reference push order, geometry x 2^octave

Every count is exact, so no capacity buckets, chunk programs or streams
are needed (the JAX package's exist for XLA's static shapes and a remote
TPU runtime).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.pipeline import features, pyramid
from sift3d_torch.utils.timing import StageTimer


def extract_octaves(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[StageTimer] = None,
) -> Iterator[Tuple[int, dict]]:
    """Yield (octave, rows) for every octave that emits features; rows is
    ``features.emit_octave``'s dict (octave-local geometry, rows sorted in
    reference push order)."""
    dev = resolve_device(device, like=img)
    timer = timer or StageTimer(enabled=False)
    sigmas = tuple(cfg.level_sigmas())
    if not isinstance(img, torch.Tensor):
        # a copy: the NIfTI reader's arrays are read-only
        img = torch.from_numpy(np.array(img, np.float32))
    vol = img.to(device=dev, dtype=torch.float32).contiguous()
    if vol.ndim != 3:
        raise ValueError(f"expected a [Z, Y, X] volume, got shape {tuple(vol.shape)}")
    with timer.stage("initial_blur"):
        base = pyramid.initial_blur_core(vol, cfg)
    for octave in range(pyramid.num_octaves(tuple(vol.shape), cfg)):
        with timer.stage("pyramid"):
            gstack, dogs, mask, base = pyramid.octave_core(base, cfg)
        rows = features.emit_octave(gstack, dogs, mask, cfg, sigmas, timer)
        if rows is None:
            continue
        order = torch.argsort(rows["key"], stable=True)
        yield octave, {k: v[order] for k, v in rows.items()}


def extract_features(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[StageTimer] = None,
) -> FeatureSet:
    """Extract 3D SIFT features (GoH descriptors, reoriented copies) from a
    [Z, Y, X] volume (numpy array or tensor).

    device: where to run (a CUDA device runs the hand-written kernels, the
    CPU their plain versions); None means the tensor's own device, or the
    CPU for a numpy array. Returns features in voxel coordinates of the
    input volume, ordered as the JAX package orders them.
    """
    parts = []
    for octave, rows in extract_octaves(img, cfg, device, timer):
        factor = np.float32(2.0**octave)  # octave scaling (MultiScale.cpp:531-543)
        host = {k: v.cpu().numpy() for k, v in rows.items()}
        parts.append(
            FeatureSet(
                xyz=host["xyz"] * factor,
                scale=host["scale"] * factor,
                ori=host["ori"],
                eigs=host["eigs"],
                info=host["info"].astype(np.uint32),
                desc=host["desc"].astype(np.float32),
            )
        )
    return FeatureSet.concatenate(parts)
