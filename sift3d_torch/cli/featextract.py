"""featextract — the PyTorch port's volumetric feature extraction CLI.

Usage:

    python -m sift3d_torch.cli.featextract [options] <input image> <output features>

      <input image>:  nifti (.nii, .nii.gz, .hdr)
      <output features>: .key text file
      -w   : world coordinates (qto_xyz; -ws uses sto_xyz), implies
             isotropic resampling (on the card)
      -2+  : double input image size       -2- : halve input image size
      -b   : BRIEF descriptor   -br : RRIEF   -bn : NRRIEF
      -d<N>: CUDA device index (default 0); the port runs on the card,
             through its hand-written kernels, and needs one. Any other
             -d... (-d, -dx) means the default card
      --debug-pgm : write the mid XY slice of the input (image.pgm) and of
             each octave's first blur level (image_o<N>.pgm) to the
             current directory
      --spatial[=N] : Z-shard the volume over N CUDA devices (all by
             default) and run the first octaves sharded: for volumes too
             large for one card
      --spatial-octaves=K : shard the first K octaves (default: those
             whose working set exceeds 2 GiB)
      --time : record the extraction's spans and print, per span, its
             calls, host ms, self ms (less the spans inside it) and
             stream ms (between CUDA events on the card's stream), then
             the counters (the staging ring's volumes, bytes and slot
             waits; with -w the resampled volumes and bytes); no span
             waits for the card

Every flag of ``sift3d.cli.featextract``, step for step and with the same
comment headers, so the two .key files can be compared line by line (they
differ at most in the last printed digit of orientations and eigenvalues:
ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import contextlib
import sys

import torch

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.core.device import resolve_device
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.dist.spatial import extract_features_spatial
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.kernels.resample import subsample_2x
from sift3d_torch.pipeline.extract import (
    Scan, device_volume, extract_features, extraction_shape, in_world_mm, prescaled_volume,
)
from sift3d_torch.utils.pgm import write_volume_slice
from sift3d_torch.utils.timing import TRACER

DESCRIPTOR_FLAGS = {"-b": "brief", "-br": "rrief", "-bn": "nrrief"}


def print_options():
    print(__doc__)


def main(argv=None, device=None) -> int:
    """Run the CLI. device: where to extract; None means cuda:<N> from -d<N>
    (cuda:0 without it), or with --spatial[=N] the first N CUDA devices
    (all without N), and raises when there is no CUDA card. Passing a
    device (such as "cpu", the kernels' plain versions) is for callers
    that hold the port against another implementation; --spatial=N then
    puts N shards on that one device."""
    argv = list(sys.argv[1:] if argv is None else argv)
    index = 0
    double_image = 0
    world_coords = 0
    descriptor = "goh"
    show_time = False
    debug_pgm = False
    spatial_devices = None  # None: no sharding; 0: every device
    spatial_octaves = None
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a.startswith("-2"):
            double_image = -1 if a[2:3] == "-" else 1
        elif a.startswith("-d"):
            # -d<N> picks cuda:N; any other -d... means the default card, as
            # the JAX CLI accepts and ignores every -d...
            index = int(a[2:]) if a[2:].isdigit() else 0
        elif a in ("-w", "-W"):
            world_coords = 1
        elif a in ("-ws", "-WS", "-wS", "-Ws"):
            world_coords = 2
        elif a in DESCRIPTOR_FLAGS:
            descriptor = DESCRIPTOR_FLAGS[a]
        elif a == "--time":
            show_time = True
        elif a == "--debug-pgm":
            debug_pgm = True
        elif a.startswith("--spatial"):
            # Z-shard the volume over N devices (sift3d_torch.dist.spatial)
            try:
                if a.startswith("--spatial-octaves="):
                    spatial_octaves = int(a.split("=", 1)[1])
                    if spatial_devices is None:
                        spatial_devices = 0
                elif a == "--spatial" or a.startswith("--spatial="):
                    spatial_devices = int(a.split("=", 1)[1]) if "=" in a else 0
                else:
                    raise ValueError(a)
            except ValueError:
                print(f"Error: unknown command line argument: {a}")
                print_options()
                return -1
        else:
            print(f"Error: unknown command line argument: {a}")
            print_options()
            return -1
        i += 1
    if len(argv) - i < 2:
        print_options()
        return -1
    in_path, out_path = argv[i], argv[i + 1]
    mesh = None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "featextract-torch runs on a CUDA card and found none; the JAX "
                "package's CLI (python -m sift3d.cli.featextract) runs on other devices"
            )
        device = f"cuda:{index}"
        if spatial_devices is not None:
            n_dev = torch.cuda.device_count()
            n = n_dev if spatial_devices == 0 else min(spatial_devices, n_dev)
            mesh = make_mesh(devices=[f"cuda:{d}" for d in range(n)])
            device = mesh[0]
    elif spatial_devices is not None:
        mesh = make_mesh(space=max(spatial_devices, 1), devices=[device])

    print(f"Extracting features: {in_path}")
    try:
        vol = nifti.read_volume(in_path)
    except (OSError, ValueError) as e:
        print(f"Error: could not read input file: {in_path} ({e})")
        return -1
    dev = resolve_device(device)
    # --time records from the upload on: the staging counts, then the spans
    with TRACER.record(dev) if show_time else contextlib.nullcontext():
        dx, dy, dz = vol.voxel_size
        scan = None
        if world_coords:
            # -w / -ws: the header's world coordinates, the volume resampled on
            # the device to the isotropic grid of its smallest voxel size
            # (featExtract.cpp:118-204) by the pipeline's prescale "isotropic"
            scan = Scan(vol.data, vol.voxel_size, vol.world_matrix(use_sform=(world_coords == 2)))
            data = prescaled_volume(scan, "isotropic", dev)
            dx = dy = dz = min(dx, dy, dz)
        else:
            data = device_volume(vol.data, dev)

        cfg = DEFAULT_CONFIG
        # -2+: the pipeline doubles the volume on the device and returns the
        # features in the input's voxels, sharded or not. -2-: halved here, by
        # this module's subsample_2x (a caller may substitute its own: the
        # tests feed the JAX package's), then scaled back by the size factor
        # below
        prescale = "double" if double_image == 1 else None
        if double_image == -1:
            data = subsample_2x(data)
        shape = extraction_shape(data.shape, prescale)
        if shape[0] <= 1:
            print(f"Could not read volume: {in_path}")
            return -1
        print(f"Input image: i={shape[2]} j={shape[1]} k={shape[0]}")

        on_gstack = None
        if debug_pgm:
            # the input's mid XY slice, then each octave's first blur level (the
            # reference writes octave 0's to 'image.pgm', MultiScale.cpp:374-384)
            write_volume_slice("image.pgm", prescaled_volume(data, prescale, dev))

            def on_gstack(octave, gstack):
                write_volume_slice(f"image_o{octave}.pgm", gstack[1])

        if mesh is not None:
            feats = extract_features_spatial(
                data, mesh, cfg, sharded_octaves=spatial_octaves, timer=TRACER, prescale=prescale,
                descriptor=descriptor, on_gstack=on_gstack,
            )
        else:
            feats = extract_features(
                data, cfg, device=dev, timer=TRACER, prescale=prescale, descriptor=descriptor, on_gstack=on_gstack,
            )

    # size factor for -2- (featExtract.cpp:422-427, 502-505)
    if double_image == -1:
        feats.xyz *= 2.0
        feats.scale *= 2.0

    if world_coords:
        # coordinates, scale and orientation to world space (featExtract.cpp:507-538)
        feats = in_world_mm(feats, scan)

    comments = [
        "Extraction Voxel Resolution (ijk) : %d %d %d" % (shape[2], shape[1], shape[0]),
        "Extraction Voxel Size (mm)  (ijk) : %f %f %f" % (dx, dy, dz),
    ]
    if world_coords:
        space = "qto_xyz" if world_coords == 1 else "sto_xyz"
        world = scan.grid_world()
        comments.append(
            "Feature Coordinate Space: millimeters (%s) : %f %f %f %f %f %f %f %f %f %f %f %f 0.0 0.0 0.0 1.0"
            % (space, *world[0, :], *world[1, :], *world[2, :])
        )
    else:
        comments.append(
            "Feature Coordinate Space: voxels: 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0"
        )
    n = keyfile.write_text(feats, out_path, eig_threshold=cfg.eig_threshold, comments=comments)
    if show_time:
        print(TRACER.summary())
    print(f"\nFeatures: {n}")
    print("\nDone.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
