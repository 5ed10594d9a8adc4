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

``prescale`` is the one resolution knob of every extraction entry point,
the Z-sharded one (``dist/spatial.py``) and placement (``dist/batch.py``)
included; this module alone turns it into the extraction grid. "double" is
featExtract's ``-2+``: a host volume is staged at its own size, then doubled
on the card (``kernels/resample_cuda.double_size_batch``, one launch a
batch) into the extraction grid, the initial blur assumes the doubled
image's sigma_init / 0.5, and the FeatureSets come back in the input
volume's voxel coordinates (location and scale x 0.5,
featExtract.cpp:422-427, 502-505). "isotropic" is featExtract's ``-w`` /
``-ws``: each input is a :class:`Scan`, a volume with its voxel size and
voxel-to-world matrix; it is staged at its own size, resampled on the card
to the isotropic grid of its smallest voxel size
(``kernels/resample_cuda.isotropic_resample_batch``, one launch a batch;
a volume of isotropic voxels is not resampled, as featExtract leaves it),
extracted there at the unscaled initial blur, and its FeatureSet comes
back in world millimetres (:func:`in_world_mm`, featExtract.cpp:162-176,
507-538). Volumes are grouped by host shape and, under "isotropic", voxel
size. A shape group
whose octave-0 pyramid would not fit the device's memory runs as balanced
sub-batches, one after another on the device's stream
(:func:`plan_subbatches`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sift3d_torch.core.config import DEFAULT_CONFIG, SiftConfig
from sift3d_torch.core.device import resolve_device
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.kernels.resample import isotropic_shape
from sift3d_torch.kernels.resample_cuda import double_size_batch, doubled_shape, isotropic_resample_batch
from sift3d_torch.pipeline import features, pyramid, staging
from sift3d_torch.utils.timing import TRACER, Tracer

# prescale -> the extraction grid's voxel size in input voxels: the factor
# that takes its coordinates back to the input volume's
# (featExtract.cpp:422-427, 502-505), and its initial image scale (the
# initial blur assumes sigma_init / it, MultiScale.cpp:288-291)
SIZE_FACTORS = {None: 1.0, "double": 0.5}
# "isotropic" maps its features to world millimetres by each Scan's own
# geometry (in_world_mm), not by a factor
PRESCALES = (*SIZE_FACTORS, "isotropic")
# device memory a call leaves to everything but its batches' pyramids
MARGIN_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class Scan:
    """A [Z, Y, X] volume (numpy array or tensor) with the geometry of its
    header: the input of prescale "isotropic", featExtract's -w / -ws.
    voxel_size: (dx, dy, dz) in mm; world: the 4x4 voxel-to-world matrix of
    its grid (``NiftiImage.world_matrix``: qto_xyz for -w, sto_xyz for
    -ws)."""

    data: Any
    voxel_size: Tuple[float, float, float]
    world: np.ndarray

    def grid_world(self) -> np.ndarray:
        """The voxel-to-world matrix of the grid it is extracted at: world's
        columns times min / d (featExtract.cpp:162-176); world itself for
        cubic voxels, whose factors are 1."""
        dx, dy, dz = (float(v) for v in self.voxel_size)
        dmin = min(dx, dy, dz)
        m = np.array(self.world, dtype=np.float64)
        m[:3, :3] = m[:3, :3] * np.array([dmin / dx, dmin / dy, dmin / dz])[None, :]
        return m


def in_world_mm(fs: FeatureSet, scan: Scan) -> FeatureSet:
    """fs, in voxels of the grid scan is extracted at, in world millimetres:
    location, scale and orientation through ``grid_world`` by
    ``FeatureSet.similarity_transform`` (featExtract.cpp:507-538), as
    ``featextract -w`` writes them."""
    return fs.similarity_transform(scan.grid_world())


def _data(img):
    """img's volume: a Scan's data, else img."""
    return img.data if isinstance(img, Scan) else img


def _voxel_size(img, prescale: Optional[str]) -> Optional[tuple]:
    """img's voxel size under prescale "isotropic", which takes Scans only;
    None under any other, which takes no Scan."""
    if (prescale == "isotropic") != isinstance(img, Scan):
        raise ValueError(f"prescale 'isotropic' takes Scans and every other prescale none; got prescale "
                         f"{prescale!r} and a {type(img).__name__}")
    return None if prescale != "isotropic" else tuple(float(v) for v in img.voxel_size)


def _shape(img) -> tuple:
    """img's host shape (a Scan's data's), which has to be [Z, Y, X]."""
    shape = tuple(np.shape(_data(img)))
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


def extraction_shape(shape_zyx, prescale: Optional[str] = None, voxel_size=None) -> tuple:
    """The [Z, Y, X] that a volume of shape shape_zyx is extracted at; under
    "isotropic" that of voxel size (dx, dy, dz)."""
    if prescale == "double":
        return doubled_shape(shape_zyx)
    if prescale == "isotropic" and _resampled(voxel_size):
        return isotropic_shape(shape_zyx, voxel_size)
    return tuple(int(n) for n in shape_zyx)


def _resampled(voxel_size) -> bool:
    """Whether "isotropic" resamples a volume of voxel size (dx, dy, dz):
    unless its voxels are cubes (featExtract.cpp:118-204)."""
    if voxel_size is None:
        raise ValueError("prescale 'isotropic' needs the volume's voxel size")
    dx, dy, dz = voxel_size
    return not dx == dy == dz


def _initial_scale(prescale: Optional[str], pre_blurred: bool = False) -> float:
    """The initial image scale of the extraction grid under prescale (1.0,
    or 0.5 for "double"; "isotropic" extracts at the resampled grid's own
    scale, 1.0); raises on an unknown prescale and on one combined with
    pre_blurred, whose input skips the initial blur."""
    if prescale not in PRESCALES:
        raise ValueError(f"prescale must be None, 'double' or 'isotropic', got {prescale!r}")
    if prescale is not None and pre_blurred:
        raise ValueError("prescale sets the initial blur, which pre_blurred skips: pass not both")
    return SIZE_FACTORS.get(prescale, 1.0)


def volume_bytes(grid_zyx) -> int:
    """Device bytes one volume of a batch on the extraction grid grid_zyx
    holds at its pyramid's peak: ``pyramid.OCTAVE0_VOLUMES`` f32 volumes."""
    return math.ceil(pyramid.OCTAVE0_VOLUMES * 4 * math.prod(int(n) for n in grid_zyx))


def plan_subbatches(grid_zyx, n: int, budget_bytes: Optional[int]) -> List[int]:
    """The sizes of the sub-batches that n volumes of the extraction grid
    grid_zyx run as: n split as evenly as possible into the fewest k parts
    (sizes ceil(n / k) and one less) whose largest fits budget_bytes at
    :func:`volume_bytes` a volume; one volume a part where not even one
    fits. budget_bytes None: one part."""
    if n <= 0:
        return []
    fit = n if budget_bytes is None else max(1, min(n, int(budget_bytes) // volume_bytes(grid_zyx)))
    k = -(-n // fit)
    return [n // k + (i < n % k) for i in range(k)]


def device_budget(dev: torch.device) -> Optional[int]:
    """The bytes a shape group's sub-batches may take on dev, read at the
    call: the device's free memory (``torch.cuda.mem_get_info``) and what
    torch's allocator holds unused, less MARGIN_BYTES; None for the CPU,
    whose batches are never split."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return free + cached - MARGIN_BYTES


def _input(imgs: Sequence, shape: tuple, dev: torch.device, prescale: Optional[str], timer: Tracer,
           single: bool = False) -> torch.Tensor:
    """The [B, Z, Y, X] extraction batch of imgs (all of host shape
    `shape`; under "isotropic" Scans of one voxel size): the batch at the
    input's size (``_batch``; single: ``device_volume``'s batch of one) in
    the span ``input``, then under prescale "double" doubled in the span
    ``upsample``, which counts the doubled batch's bytes as
    ``upsampled_bytes``, or under "isotropic" resampled in the span
    ``resample``, which counts the resampled volumes and their bytes as
    ``resampled_volumes`` and ``resampled_bytes``."""
    voxel_size = _voxel_size(imgs[0], prescale)
    imgs = [_data(img) for img in imgs]
    with timer.stage("input"):
        batch = device_volume(imgs[0], dev)[None] if single else _batch(imgs, shape, dev)
    if prescale == "isotropic" and _resampled(voxel_size):
        with timer.stage("resample"):
            out = torch.empty((batch.shape[0],) + isotropic_shape(shape, voxel_size), dtype=torch.float32,
                              device=dev)
            isotropic_resample_batch(batch, out, voxel_size)
        TRACER.count("resampled_volumes", out.shape[0])
        TRACER.count("resampled_bytes", out.numel() * out.element_size())
        return out
    if prescale != "double":
        return batch
    with timer.stage("upsample"):
        out = torch.empty((batch.shape[0],) + doubled_shape(shape), dtype=torch.float32, device=dev)
        double_size_batch(batch, out)
    TRACER.count("upsampled_bytes", out.numel() * out.element_size())
    return out


def prescaled_volume(img, prescale: Optional[str], device=None) -> torch.Tensor:
    """img (a [Z, Y, X] volume, or a Scan under "isotropic") on the device
    as the entry points extract it under prescale: doubled or resampled by
    the kernel on a card, or as it is (the Z-sharded path's input, the
    CLI's -w volume and its --debug-pgm slice)."""
    dev = resolve_device(device, like=_data(img))
    return _input([img], _shape(img), dev, prescale, TRACER, single=True)[0]


def _in_input_voxels(fs: FeatureSet, prescale: Optional[str]) -> FeatureSet:
    """fs, extracted on the prescaled grid, in the input volume's voxel
    coordinates: location and scale times the size factor, in place."""
    if prescale is not None:
        factor = np.float32(SIZE_FACTORS[prescale])
        fs.xyz *= factor
        fs.scale *= factor
    return fs


def _output(fs: FeatureSet, prescale: Optional[str], img) -> FeatureSet:
    """fs, extracted from img on the grid prescale gives it, as the entry
    points return it: in world millimetres under "isotropic"
    (:func:`in_world_mm`), else in the input volume's voxels."""
    return in_world_mm(fs, img) if prescale == "isotropic" else _in_input_voxels(fs, prescale)


def _batch_octaves(
    batch: torch.Tensor, cfg: SiftConfig, timer: Tracer, scale: float, descriptor: str, on_gstack: Optional[Callable[[int, torch.Tensor], None]], pre_blurred: bool,
) -> Iterator[Tuple[int, dict]]:
    """The body of every entry point: a [B, Z, Y, X] batch of same-shape
    volumes through the pyramid and the feature stage, octave by octave.
    Yields (octave, rows) for every octave that emits features; rows is
    ``features.emit_octave``'s dict (octave-local geometry, column vi),
    sorted by volume, then reference push order. scale: the batch's
    initial image scale (``_initial_scale``). on_gstack(octave, gstack)
    gets each octave's [B, 6, Z, Y, X] stack. Every span closes before a
    yield."""
    sigmas = tuple(cfg.level_sigmas())
    if pre_blurred:
        base = batch
    else:
        with timer.stage("initial_blur"):
            base = pyramid.initial_blur_core(batch, cfg, scale)
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
    *, descriptor: str = "goh", on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None,
    pre_blurred: bool = False, prescale: Optional[str] = None,
) -> Iterator[Tuple[int, dict]]:
    """Yield (octave, rows) for every octave of one volume that emits
    features: the batched body on a batch of one. rows is
    ``features.emit_octave``'s dict without vi (octave-local geometry of
    the extraction grid, rows sorted in reference push order). device,
    descriptor, on_gstack and prescale as in :func:`extract_features`; pre_blurred: img is already an octave base
    (the tail octaves of the Z-sharded path), so the initial blur is
    skipped. The batch of one is a view of :func:`device_volume`'s tensor
    (a host volume bound for a card staged through the device's ring), or
    its doubled or resampled copy."""
    timer = timer or TRACER
    scale = _initial_scale(prescale, pre_blurred)
    dev = resolve_device(device, like=_data(img))
    batch = _input([img], _shape(img), dev, prescale, timer, single=True)
    hook = None if on_gstack is None else (lambda octave, gstack: on_gstack(octave, gstack[0]))
    for octave, rows in _batch_octaves(
        batch, cfg, timer, scale, descriptor, hook, pre_blurred,
    ):
        del rows["vi"]
        yield octave, rows


def extract_features(
    img, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[Tracer] = None,
    *, descriptor: str = "goh", on_gstack: Optional[Callable[[int, torch.Tensor], None]] = None,
    prescale: Optional[str] = None,
) -> FeatureSet:
    """Extract 3D SIFT features (reoriented copies included) from a
    [Z, Y, X] volume (numpy array or tensor; a :class:`Scan` under
    prescale "isotropic").

    device: where to run (a CUDA device runs the hand-written kernels, the
    CPU their plain versions); None means the card (a CUDA tensor's own
    device, else the current CUDA device) and raises without one.
    timer: what opens the spans (``utils.timing``; None: the process's
    tracer).
    descriptor: "goh" (default), "brief", "rrief" or "nrrief". on_gstack:
    called as on_gstack(octave, gstack) with every octave's [6, Z, Y, X]
    Gaussian stack before its features (the CLI's --debug-pgm).
    prescale: None, "double" (featExtract's -2+: the volume doubled on
    the device, its initial blur from sigma_init / 0.5) or "isotropic"
    (featExtract's -w / -ws on a Scan: resampled on the device to the
    isotropic grid of its smallest voxel size). Returns features in voxel
    coordinates of the input volume, under "isotropic" in world
    millimetres, ordered as the JAX package orders them.
    """
    timer = timer or TRACER
    parts = []
    for octave, rows in extract_octaves(
        img, cfg, device, timer, descriptor=descriptor, on_gstack=on_gstack, prescale=prescale,
    ):
        with timer.stage("emit"):
            parts.append(octave_features(rows, octave))
    with timer.stage("emit"):
        return _output(FeatureSet.concatenate(parts), prescale, img)


def extract_features_many(
    imgs: Sequence, cfg: SiftConfig = DEFAULT_CONFIG, device=None, timer: Optional[Tracer] = None,
    *, descriptor: str = "goh", pre_blurred: bool = False, prescale: Optional[str] = None,
) -> List[FeatureSet]:
    """Extract features from several [Z, Y, X] volumes (numpy arrays or
    tensors; Scans under prescale "isotropic"); returns one FeatureSet per
    input, in input order, each equal bit for bit to
    :func:`extract_features` on that volume alone.

    Volumes of one host shape (and, under "isotropic", one voxel size)
    advance together: one batch, one pyramid per
    shape group and one candidate union per (group, octave), so the kernel
    launches and host syncs of an octave are paid once per group
    (``sift3d.pipeline.extract.extract_features_many``). A group whose
    pyramid would not fit the device's memory (:func:`device_budget`, read
    once a group) runs as the balanced sub-batches of
    :func:`plan_subbatches`, in order, each opening one span ``input``;
    the counter ``subbatches`` counts them. Each sub-batch's batch is
    allocated once on the device and filled volume by volume (host volumes
    bound for a card through the device's staging ring), so no volume has
    a device tensor of its own; with prescale, the batch is then doubled or
    resampled into the extraction batch. A volume without features gives an
    empty set.
    device, timer, descriptor and prescale as in :func:`extract_features`; pre_blurred as in :func:`extract_octaves`.
    The JAX package's ``streams`` (a TPU runtime's overlap of host reads
    with device work) is not ported; it changes no result.
    """
    scale = _initial_scale(prescale, pre_blurred)
    dev = resolve_device(device, like=_data(imgs[0]) if len(imgs) else None)
    timer = timer or TRACER
    groups: dict = {}
    for i, img in enumerate(imgs):
        groups.setdefault((_shape(img), _voxel_size(img, prescale)), []).append(i)
    parts = [[] for _ in imgs]
    for (shape, voxel_size), group in groups.items():
        at = 0
        grid = extraction_shape(shape, prescale, voxel_size)
        for size in plan_subbatches(grid, len(group), device_budget(dev)):
            vol_ids, at = group[at : at + size], at + size
            TRACER.count("subbatches")
            _subbatch([imgs[i] for i in vol_ids], shape, dev, cfg, timer, scale, descriptor, pre_blurred,
                      prescale, [parts[i] for i in vol_ids])
    with timer.stage("emit"):
        return [_output(FeatureSet.concatenate(p), prescale, img) for p, img in zip(parts, imgs)]


def _subbatch(imgs: Sequence, shape: tuple, dev: torch.device, cfg: SiftConfig, timer: Tracer,
              scale: float, descriptor: str, pre_blurred: bool, prescale: Optional[str],
              parts: List[list]) -> None:
    """One sub-batch of :func:`extract_features_many`: imgs through the
    pyramid and the feature stage as one batch; each octave's FeatureSet
    of volume b is appended to parts[b]. Its batches are freed on return,
    before the next sub-batch allocates its own."""
    batch = _input(imgs, shape, dev, prescale, timer)
    for octave, rows in _batch_octaves(
        batch, cfg, timer, scale, descriptor, None, pre_blurred
    ):
        with timer.stage("emit"):
            host = {k: v.cpu().numpy() for k, v in rows.items()}
            # rows are sorted by volume: volume b's are one run
            bounds = np.searchsorted(host["vi"], np.arange(len(imgs) + 1))
            for b in range(len(imgs)):
                lo, hi = bounds[b], bounds[b + 1]
                if hi > lo:
                    parts[b].append(octave_features({k: v[lo:hi] for k, v in host.items()}, octave))


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
