"""PyTorch port: ``extract_features_many(..., prescale="isotropic")`` on a
batch of scans of mixed voxel sizes against the JAX package's
``featextract -w`` one scan at a time, on the CPU.

Each scan resamples to a 64^3 grid, where XLA's CPU dots sum the blur
taps in the port's order (ROADMAP.md, Queue 3), along z, y or x, or to a
65x64x64 grid at the OASIS-1 scans' 1 x 1 x 1.25 mm, under a rotated,
offset qform. The resample and the world mapping are exact on
both sides (tests/test_torch_resample.py); the rows are held to the rules
of tests/test_torch_cli_flags.py: the same row count, repeatability 1.0
both ways, locations and scales within 1e-4, equal info flags,
orientations within 1e-3, eigenvalues within rtol 1e-4, descriptors
identical on >= 99% of rows (the reasons are given there). The volumes
are test_torch_extract_e2e.py's exact-parity seeds 3 and 7, and seed 5,
a case expected to fail (strict): on synthetic_volume(64, seed=5) the
port's and the JAX package's extract_features place a few rows up to
6.4e-4 voxels apart, and up to 3.0e-4 on every other plane of it
resampled (the two resamples equal), without -w as with it (ROADMAP.md,
Queue 3 item 3).
"""

import numpy as np
import pytest
import torch

from sift3d.cli import featextract as jx_cli
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.pipeline.extract import Scan, extract_features_many
from sift3d_torch.utils.synthetic import repeatability, synthetic_volume

torch.set_num_threads(1)


def _affine(seed, voxel_size, offset):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    m = np.eye(4)
    m[:3, :3] = q * np.sign(np.linalg.det(q)) * np.asarray(voxel_size, np.float64)
    m[:3, 3] = offset
    return m


# every other voxel of a 64^3 volume along one axis, at 2 mm along it, and
# 52 planes of one at the OASIS-1 scans' 1 x 1 x 1.25 mm (grid 65x64x64)
SCANS = {
    "z": (lambda v: v[::2], (1.0, 1.0, 2.0), 7),
    "y": (lambda v: v[:, ::2], (1.0, 2.0, 1.0), 7),
    "x": (lambda v: v[:, :, ::2], (2.0, 1.0, 1.0), 3),
    "z1.25": (lambda v: v[:52], (1.0, 1.0, 1.25), 7),
    "z_seed5": (lambda v: v[::2], (1.0, 1.0, 2.0), 5),
}
# seed 5 keeps the known location gap in view: a repair of it flips the mark
CASES = [pytest.param(a, marks=pytest.mark.xfail(strict=True, reason="ROADMAP Queue 3 item 3"))
         if a == "z_seed5" else a for a in sorted(SCANS)]


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{axis: (the JAX CLI's .key rows, the port's batch rows through a .key)}."""
    d = tmp_path_factory.mktemp("scans")
    paths, scans = {}, {}
    for axis, (cut, voxel_size, seed) in SCANS.items():
        paths[axis] = str(d / f"{axis}.nii")
        nifti.write(paths[axis], np.ascontiguousarray(cut(synthetic_volume(64, seed=seed))), voxel_size=voxel_size,
                    qto_xyz=_affine(seed, voxel_size, [-31.5, 20.25, -12.0]))
        vol = nifti.read_volume(paths[axis])
        scans[axis] = Scan(vol.data, vol.voxel_size, vol.world_matrix())
    got = extract_features_many(list(scans.values()), device="cpu", prescale="isotropic")
    out = {}
    for axis, feats in zip(scans, got):
        keyfile.write_text(feats, str(d / f"{axis}.port.key"))
        assert jx_cli.main(["-w", paths[axis], str(d / f"{axis}.jax.key")]) == 0
        out[axis] = (keyfile.read_text(str(d / f"{axis}.jax.key"))[0], keyfile.read_text(str(d / f"{axis}.port.key"))[0])
    return out


@pytest.mark.parametrize("axis", CASES)
def test_the_isotropic_batch_matches_jax_w(axis, rows):
    want, got = rows[axis]
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.info, want.info)
    np.testing.assert_allclose(got.ori, want.ori, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.eigs, want.eigs, rtol=1e-4, atol=1e-6)
    same = float((got.desc == want.desc).all(axis=1).mean())
    print(f"{axis}: {len(got)} rows, identical descriptors {same:.4f}")
    assert same >= 0.99
