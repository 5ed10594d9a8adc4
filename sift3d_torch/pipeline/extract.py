"""Feature extraction, single-volume and batched, run eagerly.

PyTorch port of ``sift3d.pipeline.extract.extract_features_many`` (and
``extract_features``, its batch of one) with GoH descriptors and reoriented
copies (the `featextract in.nii out.key` path). Volumes of one shape advance
together as one [B, Z, Y, X] batch:

  initial blur -> per octave: Gaussian stacks, DoGs + extrema (K1), one
                  launch each for the batch
               -> one candidate union (nonzero + stable sort; volume index vi)
               -> refinement, bounds test, identity patches (K2), eigen test
               -> canonical orientations (K3)
               -> rotated patches (K4), GoH descriptors
               -> rows sorted by (volume, reference push order), split per
                  volume, geometry x 2^octave

so the launches and host syncs of an octave are paid once per shape group,
not once per volume, and every volume's rows equal its rows alone, bit for
bit. Inputs are grouped by their host shapes before any upload; each group's
batch is allocated once on the device, and a host volume bound for a card
(a numpy array or a CPU tensor) travels through the device's pinned staging
ring (``pipeline/staging.py``) straight into its place in the batch: one
host pass casts it to f32 chunk by chunk, and every transfer is an
asynchronous copy from pinned memory that overlaps the next chunk's host
pass. A tensor already on a card, and every input on the CPU, is converted
as it always was (``_volume``) and written into the batch (a single
volume's batch of one is a view of it). Every count is
exact, so no capacity buckets, chunk programs or streams are needed (the
JAX package's exist for XLA's static shapes and a remote TPU runtime; its
``streams`` option changes no result and is not ported).
The entry points run on the card unless the caller passes device="cpu". A
volume too large for one card goes through
``sift3d_torch.dist.spatial.extract_features_spatial``.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.pipeline import features, pyramid, staging
from sift3d_torch.utils.timing import TRACER, Tracer


def _shape(img) -> tuple:
    """img's host shape, which has to be [Z, Y, X]."""
    shape = tuple(np.shape(img))
    if len(shape) != 3:
        raise ValueError(f"expected a [Z, Y, X] volume, got shape {shape}")
    return shape


def _staged(img, dev: torch.device) -> bool:
    """Whether img reaches dev through the staging ring: a host array or a
    CPU tensor bound for a card."""
    return dev.type == "cuda" and not (isinstance(img, torch.Tensor) and img.device.type != "cpu")


def _volume(img, dev: torch.device) -> torch.Tensor:
    """img (numpy array or tensor) as a contiguous f32 [Z, Y, X] tensor on
    dev, by a host copy and a plain upload: the path of inputs that bypass
    the staging ring."""
    if not isinstance(img, torch.Tensor):
        # a copy: the NIfTI reader's arrays are read-only
        img = torch.from_numpy(np.array(img, np.float32))
    return img.to(device=dev, dtype=torch.float32).contiguous()


def _batch(imgs: Sequence, shape: tuple, dev: torch.device) -> torch.Tensor:
    """The volumes imgs, all of the [Z, Y, X] shape `shape`, as one f32
    [B, Z, Y, X] tensor on dev, allocated once: volume b is staged into
    batch[b] through the device's ring (the host copies of a batch of
    several on torch's threads, of a single volume on this thread alone:
    ``pipeline/staging.py``), or, bypassing it, converted by ``_volume``
    and copied there."""
    batch = torch.empty((len(imgs),) + shape, dtype=torch.float32, device=dev)
    for b, img in enumerate(imgs):
        if _staged(img, dev):
            staging.ring(dev).stage(img, batch[b], parallel=len(imgs) > 1)
        else:
            batch[b] = _volume(img, dev)
    return batch


def device_volume(img, device) -> torch.Tensor:
    """img (a [Z, Y, X] numpy array or tensor) as a contiguous f32 tensor on
    device: a host volume bound for a card through the device's staging
    ring, any other input by ``_volume``."""
    dev = torch.device(device)
    shape = _shape(img)
    return _batch([img], shape, dev)[0] if _staged(img, dev) else _volume(img, dev)


def _batch_octaves(
    batch: torch.Tensor, cfg: SiftConfig, timer: Tracer, initial_image_scale: float,
    descriptor: str, on_gstack: Optional[Callable[[int, torch.Tensor], None]], pre_blurred: bool,
) -> Iterator[Tuple[int, dict]]:
    """The body of every entry point: a [B, Z, Y, X] batch of same-shape
    volumes through the pyramid and the feature stage, octave by octave.
    Yields (octave, rows) for every octave that emits features; rows is
    ``features.emit_octave``'s dict (octave-local geometry, column vi),
    sorted by volume, then reference push order. on_gstack(octave, gstack)
    gets each octave's [B, 6, Z, Y, X] stack. Every span closes before a
    yield."""
    sigmas = tuple(cfg.level_sigmas())
    if pre_blurred:
        base = batch
    else:
        with timer.stage("initial_blur"):
            base = pyramid.initial_blur_core(batch, cfg, initial_image_scale)
    for octave in range(pyramid.num_octaves(tuple(batch.shape[1:]), cfg)):
        # the span "octave" holds the octave's stages and the steps between
        # them (the feature stage's row gathers and row assembly)
        with timer.stage("octave"):
            with timer.stage("pyramid"):
                gstack, dogs, mask, base = pyramid.octave_core(base, cfg)
            if on_gstack is not None:
                on_gstack(octave, gstack)
            rows = features.emit_octave(gstack, dogs, mask, cfg, sigmas, timer, descriptor)
            del gstack, dogs, mask
            if rows is None:
                continue
            with timer.stage("emit"):
                order = torch.argsort(rows["key"], stable=True)
                order = order[torch.argsort(rows["vi"][order], stable=True)]
                rows = {k: v[order] for k, v in rows.items()}
        yield octave, rows


def extract_octaves(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[Tracer] = None,
    *, initial_image_scale: float = 1.0, descriptor: str = "goh",
    on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None, pre_blurred: bool = False,
) -> Iterator[Tuple[int, dict]]:
    """Yield (octave, rows) for every octave of one volume that emits
    features: the batched body on a batch of one. rows is
    ``features.emit_octave``'s dict without vi (octave-local geometry, rows
    sorted in reference push order). device, initial_image_scale,
    descriptor and on_gstack as in :func:`extract_features`; pre_blurred:
    img is already an octave base (the tail octaves of the Z-sharded path),
    so the initial blur is skipped. The batch of one is a view of
    :func:`device_volume`'s tensor (a host volume bound for a card staged
    through the device's ring)."""
    timer = timer or TRACER
    dev = resolve_device(device, like=img)
    with timer.stage("input"):
        batch = device_volume(img, dev)[None]
    hook = None if on_gstack is None else (lambda octave, gstack: on_gstack(octave, gstack[0]))
    for octave, rows in _batch_octaves(
        batch, cfg, timer, initial_image_scale, descriptor, hook, pre_blurred,
    ):
        del rows["vi"]
        yield octave, rows


def extract_features(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[Tracer] = None,
    *, initial_image_scale: float = 1.0, descriptor: str = "goh",
    on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> FeatureSet:
    """Extract 3D SIFT features (reoriented copies included) from a
    [Z, Y, X] volume (numpy array or tensor).

    device: where to run (a CUDA device runs the hand-written kernels, the
    CPU their plain versions); None means the card (a CUDA tensor's own
    device, else the current CUDA device) and raises without one.
    timer: what opens the spans (``utils.timing``; None: the process's
    tracer).
    initial_image_scale: 0.5 for an image the CLI doubled (-2+), whose
    initial blur then assumes sigma_init / 0.5.
    descriptor: "goh" (default), "brief", "rrief" or "nrrief". on_gstack:
    called as on_gstack(octave, gstack) with every octave's [6, Z, Y, X]
    Gaussian stack before its features (the CLI's --debug-pgm). Returns
    features in voxel coordinates of the input volume, ordered as the JAX
    package orders them.
    """
    timer = timer or TRACER
    parts = []
    for octave, rows in extract_octaves(
        img, cfg, device, timer,
        initial_image_scale=initial_image_scale, descriptor=descriptor, on_gstack=on_gstack,
    ):
        with timer.stage("emit"):
            parts.append(octave_features(rows, octave))
    with timer.stage("emit"):
        return FeatureSet.concatenate(parts)


def extract_features_many(
    imgs: Sequence, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[Tracer] = None,
    *, initial_image_scale: float = 1.0, descriptor: str = "goh", pre_blurred: bool = False,
) -> List[FeatureSet]:
    """Extract features from several [Z, Y, X] volumes (numpy arrays or
    tensors); returns one FeatureSet per input, in input order, each equal
    bit for bit to :func:`extract_features` on that volume alone.

    Volumes of one host shape advance together: one batch, one pyramid per
    shape group and one candidate union per (group, octave), so the kernel
    launches and host syncs of an octave are paid once per group
    (``sift3d.pipeline.extract.extract_features_many``). Each group's batch
    is allocated once on the device and filled volume by volume (host
    volumes bound for a card through the device's staging ring), so no
    volume has a device tensor of its own. A volume without
    features gives an empty set. device, timer, initial_image_scale and
    descriptor as in :func:`extract_features`; pre_blurred as in
    :func:`extract_octaves`. The JAX package's ``streams`` (a TPU runtime's
    overlap of host reads with device work) is not ported; it changes no
    result.
    """
    dev = resolve_device(device, like=imgs[0] if len(imgs) else None)
    timer = timer or TRACER
    groups: dict = {}
    for i, img in enumerate(imgs):
        groups.setdefault(_shape(img), []).append(i)
    parts = [[] for _ in imgs]
    for shape, vol_ids in groups.items():
        with timer.stage("input"):
            batch = _batch([imgs[i] for i in vol_ids], shape, dev)
        for octave, rows in _batch_octaves(
            batch, cfg, timer, initial_image_scale, descriptor, None, pre_blurred
        ):
            with timer.stage("emit"):
                host = {k: v.cpu().numpy() for k, v in rows.items()}
                # rows are sorted by volume: volume b's are one run
                bounds = np.searchsorted(host["vi"], np.arange(len(vol_ids) + 1))
                for b, vol_i in enumerate(vol_ids):
                    lo, hi = bounds[b], bounds[b + 1]
                    if hi > lo:
                        parts[vol_i].append(octave_features({k: v[lo:hi] for k, v in host.items()}, octave))
        del batch
    with timer.stage("emit"):
        return [FeatureSet.concatenate(p) for p in parts]


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
