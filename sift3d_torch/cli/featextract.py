"""featextract — the PyTorch port's volumetric feature extraction CLI.

Usage:

    python -m sift3d_torch.cli.featextract [options] <input image> <output features>

      <input image>:  nifti (.nii, .nii.gz, .hdr)
      <output features>: .key text file
      -d<N>  : CUDA device index (default 0); the port runs on the card,
               through its hand-written kernels, and needs one
      --time : print per-stage timing summary

The default-flag path of ``sift3d.cli.featextract`` (voxel coordinates,
GoH descriptors, reoriented copies), with the same comment headers, so the
two .key files can be compared line by line (they differ at most in the
last printed digit of orientations and eigenvalues: ROADMAP.md, Queue 3).
The other flags of the JAX CLI
(-w/-ws, -2+/-2-, -b/-br/-bn, --spatial) are not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

import sys

import torch

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.pipeline.extract import extract_features
from sift3d_torch.utils.timing import StageTimer

NOT_PORTED = ("-w", "-W", "-ws", "-WS", "-wS", "-Ws", "-2+", "-2-", "-b", "-br", "-bn", "-s")


def print_options():
    print(__doc__)


def main(argv=None, device=None) -> int:
    """Run the CLI. device: where to extract; None means cuda:<N> from -d<N>
    (cuda:0 without it), and raises when there is no CUDA card. Passing a
    device (such as "cpu", the kernels' plain versions) is for callers
    that hold the port against another implementation."""
    argv = list(sys.argv[1:] if argv is None else argv)
    index = 0
    show_time = False
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a in NOT_PORTED or a.startswith("--spatial"):
            print(
                f"Error: {a} is not ported to the PyTorch package yet (ROADMAP.md, "
                "Queue 1); use python -m sift3d.cli.featextract for it."
            )
            return -1
        if a.startswith("-d") and a[2:].isdigit():
            index = int(a[2:])
        elif a == "--time":
            show_time = True
        else:
            print(f"Error: unknown command line argument: {a}")
            print_options()
            return -1
        i += 1
    if len(argv) - i < 2:
        print_options()
        return -1
    in_path, out_path = argv[i], argv[i + 1]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "featextract-torch runs on a CUDA card and found none; the JAX "
                "package's CLI (python -m sift3d.cli.featextract) runs on other devices"
            )
        device = f"cuda:{index}"

    print(f"Extracting features: {in_path}")
    try:
        vol = nifti.read_volume(in_path)
    except (OSError, ValueError) as e:
        print(f"Error: could not read input file: {in_path} ({e})")
        return -1
    data = vol.data
    dx, dy, dz = vol.voxel_size
    if data.shape[0] <= 1:
        print(f"Could not read volume: {in_path}")
        return -1
    print(f"Input image: i={data.shape[2]} j={data.shape[1]} k={data.shape[0]}")

    timer = StageTimer(enabled=show_time)
    feats = extract_features(data, DEFAULT_CONFIG, device=device, timer=timer)

    comments = [
        "Extraction Voxel Resolution (ijk) : %d %d %d" % (data.shape[2], data.shape[1], data.shape[0]),
        "Extraction Voxel Size (mm)  (ijk) : %f %f %f" % (dx, dy, dz),
        "Feature Coordinate Space: voxels: 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0",
    ]
    n = keyfile.write_text(feats, out_path, eig_threshold=DEFAULT_CONFIG.eig_threshold, comments=comments)
    if show_time:
        print(timer.summary())
    print(f"\nFeatures: {n}")
    print("\nDone.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
