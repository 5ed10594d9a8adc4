"""PyTorch port: Z-sharded extraction against the JAX package on the
64^3 cells where the port's single-device pipeline matches it
(test_torch_extract_e2e.py), and the CLI's --spatial against the port's
CLI without it.

The JAX package's own --spatial tests are too slow on this CPU to run
beside these; its docstring states that its spatial path equals its
single-device extract_features (spatial.py:460-471), which is what the
port's spatial path is held to here: equal counts and repeatability 1.0
both ways. The CLI cells hold --spatial=4 (with --spatial-octaves=2, and
alone, where the 2 GiB rule shards nothing, and with -2+ on a 32^3
volume) to the same .key rows, locations, scales and descriptors as the
CLI without it, and --debug-pgm to the same files.
"""

import os

import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.pipeline.extract import extract_features as jx_extract
from sift3d_torch.cli import featextract as tx_cli
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.dist.spatial import extract_features_spatial
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.utils.synthetic import repeatability, synthetic_blob_texture, synthetic_volume

torch.set_num_threads(1)

CELLS = {
    "synthetic64_s3": lambda: synthetic_volume(64, seed=3),
    "synthetic64_s7": lambda: synthetic_volume(64, seed=7),
    "texture64": lambda: synthetic_blob_texture((64, 64, 64), seed=7, n_blobs=30),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_spatial_matches_jax(cell):
    vol = CELLS[cell]()
    want = jx_extract(vol, JxConfig())
    got = extract_features_spatial(vol, make_mesh(4, ["cpu"]), sharded_octaves=2)
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.info, want.info)


@pytest.mark.parametrize("flags", [["--spatial=4", "--spatial-octaves=2"], ["--spatial=4"],
                                   ["--spatial=3", "--spatial-octaves=2", "--debug-pgm"],
                                   ["-2+", "--spatial=4", "--spatial-octaves=1"]])
def test_cli_spatial_matches_cli(tmp_path, flags):
    vol = synthetic_volume(64, seed=7)
    if "-2+" in flags:
        # a 32^3 volume (test_torch_prescale.py's), extracted at 64^3
        vol = np.ascontiguousarray(vol[::2, ::2, ::2])
    vol_path = str(tmp_path / "v.nii")
    nifti.write(vol_path, vol)
    dirs = {}
    for who, extra in (("plain", [f for f in flags if not f.startswith("--spatial")]), ("spatial", flags)):
        dirs[who] = tmp_path / who
        dirs[who].mkdir()
        here = os.getcwd()
        os.chdir(dirs[who])  # --debug-pgm writes to the working directory
        try:
            assert tx_cli.main([*extra, vol_path, "out.key"], device="cpu") == 0
        finally:
            os.chdir(here)
    got, want = (keyfile.read_text(str(dirs[w] / "out.key"))[0] for w in ("spatial", "plain"))
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(got.desc, want.desc)
    pgms = sorted(p.name for p in dirs["plain"].glob("*.pgm"))
    assert pgms == sorted(p.name for p in dirs["spatial"].glob("*.pgm"))
    for name in pgms:
        assert (dirs["plain"] / name).read_bytes() == (dirs["spatial"] / name).read_bytes()
    if "--debug-pgm" in flags:
        assert len(pgms) >= 2
