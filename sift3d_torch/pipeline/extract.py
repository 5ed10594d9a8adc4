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
TPU runtime). The entry points run on the card unless the caller passes
device="cpu". A volume too large for one card goes through
``sift3d_torch.dist.spatial.extract_features_spatial``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.pipeline import features, pyramid
from sift3d_torch.utils.timing import StageTimer


def extract_octaves(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[StageTimer] = None,
    *, initial_image_scale: float = 1.0, descriptor: str = "goh",
    on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None, pre_blurred: bool = False,
) -> Iterator[Tuple[int, dict]]:
    """Yield (octave, rows) for every octave that emits features; rows is
    ``features.emit_octave``'s dict (octave-local geometry, rows sorted in
    reference push order). device, initial_image_scale, descriptor and
    on_gstack as in :func:`extract_features`; pre_blurred: img is already
    an octave base (the tail octaves of the Z-sharded path), so the
    initial blur is skipped."""
    dev = resolve_device(device, like=img)
    timer = timer or StageTimer(enabled=False)
    sigmas = tuple(cfg.level_sigmas())
    if not isinstance(img, torch.Tensor):
        # a copy: the NIfTI reader's arrays are read-only
        img = torch.from_numpy(np.array(img, np.float32))
    vol = img.to(device=dev, dtype=torch.float32).contiguous()
    if vol.ndim != 3:
        raise ValueError(f"expected a [Z, Y, X] volume, got shape {tuple(vol.shape)}")
    if pre_blurred:
        base = vol
    else:
        with timer.stage("initial_blur"):
            base = pyramid.initial_blur_core(vol, cfg, initial_image_scale)
    for octave in range(pyramid.num_octaves(tuple(vol.shape), cfg)):
        with timer.stage("pyramid"):
            gstack, dogs, mask, base = pyramid.octave_core(base, cfg)
        if on_gstack is not None:
            on_gstack(octave, gstack)
        rows = features.emit_octave(gstack, dogs, mask, cfg, sigmas, timer, descriptor)
        if rows is None:
            continue
        order = torch.argsort(rows["key"], stable=True)
        yield octave, {k: v[order] for k, v in rows.items()}


def extract_features(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[StageTimer] = None,
    *, initial_image_scale: float = 1.0, descriptor: str = "goh",
    on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> FeatureSet:
    """Extract 3D SIFT features (reoriented copies included) from a
    [Z, Y, X] volume (numpy array or tensor).

    device: where to run (a CUDA device runs the hand-written kernels, the
    CPU their plain versions); None means the card (a CUDA tensor's own
    device, else the current CUDA device) and raises without one.
    initial_image_scale: 0.5 for an image the CLI doubled (-2+), whose
    initial blur then assumes sigma_init / 0.5.
    descriptor: "goh" (default), "brief", "rrief" or "nrrief". on_gstack:
    called as on_gstack(octave, gstack) with every octave's [6, Z, Y, X]
    Gaussian stack before its features (the CLI's --debug-pgm). Returns
    features in voxel coordinates of the input volume, ordered as the JAX
    package orders them.
    """
    parts = [
        octave_features(rows, octave)
        for octave, rows in extract_octaves(
            img, cfg, device, timer,
            initial_image_scale=initial_image_scale, descriptor=descriptor, on_gstack=on_gstack,
        )
    ]
    return FeatureSet.concatenate(parts)


def octave_features(rows: dict, octave: int) -> FeatureSet:
    """One octave's rows (tensors or numpy arrays, octave geometry) as a
    FeatureSet in voxel coordinates of the input volume."""
    factor = np.float32(2.0**octave)  # octave scaling (MultiScale.cpp:531-543)
    host = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in rows.items()}
    return FeatureSet(
        xyz=host["xyz"] * factor,
        scale=host["scale"] * factor,
        ori=host["ori"],
        eigs=host["eigs"],
        info=host["info"].astype(np.uint32),
        desc=host["desc"].astype(np.float32),
    )
