"""PyTorch port: the featextract flags against the JAX CLI, on the CPU
(``main(argv, device="cpu")``): the resampling and world-coordinate flags
here (-2+, -w, -ws, -2-), the descriptor flags and --debug-pgm in
test_torch_cli_flags_desc.py (two files, so that xdist spreads them).

Every cell's extraction grid is 64^3, where XLA's CPU dots sum the blur
taps in the port's order (ROADMAP.md, Queue 3): -2+ doubles a 32^3
volume, -w/-ws resample a [32, 64, 64] volume of 1x1x2 mm voxels with a
rotated, offset qform and sform, -2- halves a 128^3 volume, the rest run
at 64^3. What must hold, per flag:
- the same header and comment lines (the qto_xyz / sto_xyz line
  included) and the same row count;
- repeatability 1.0 both ways, locations and scales within 1e-4, equal
  info flags;
- orientations within 1e-3 and eigenvalues within rtol 1e-4, as in
  test_torch_extract_e2e.py: the identity patches, the patch
  normalization's and the structure tensor's sums, and glibc's
  cosf/atan2f round differently in XLA, and the eigenvector of a nearly
  degenerate structure tensor amplifies that (one row of the -2+ cell
  moves by 1.5e-4; ROADMAP.md, Queue 3);
- descriptors identical on >= 99% of rows (GoH rows can differ where an
  ulp-level patch difference swaps two ranks, Queue 3; BRIEF rows where
  the 11^3 pre-blur, summed in XLA's order, moves a pair difference
  across a tie);
- for --debug-pgm, the same PGM files, byte for byte.

-2- is the one cell where the inputs to the pyramid differ: XLA's CPU
reduce sums the 8 children of the 128^3 -> 64^3 subsample in a
shape-dependent tree (test_subsample_order_witness), the port in scan
order, so a candidate whose DoG margin is that small flips. The port's own
run is printed against JAX's; fed the JAX package's subsample, the port
must then meet every rule above.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.cli import featextract as jx_cli
from sift3d.kernels import resample as jx_resample
from sift3d_torch.cli import featextract as tx_cli
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.kernels import resample
from sift3d_torch.utils.synthetic import repeatability, synthetic_volume

torch.set_num_threads(1)


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def _affine(seed, offset):
    m = np.eye(4)
    m[:3, :3] = _rotation(seed) * np.array([1.0, 1.0, 2.0])
    m[:3, 3] = offset
    return m


VOLUMES = {
    "cube64": lambda path: nifti.write(path, synthetic_volume(64, seed=7)),
    # every other voxel of a 64^3 volume: its blobs, doubled back, are
    # large enough to detect (a 32^3 synthetic_volume's are not)
    "cube32": lambda path: nifti.write(path, np.ascontiguousarray(synthetic_volume(64, seed=3)[::2, ::2, ::2])),
    "cube128": lambda path: nifti.write(path, synthetic_volume(128, seed=7)),
    # [Z, Y, X] = [32, 64, 64] at 1 x 1 x 2 mm: resampled to 64^3
    "aniso": lambda path: nifti.write(
        path, synthetic_volume(64, seed=7)[::2], voxel_size=(1.0, 1.0, 2.0),
        qto_xyz=_affine(4, [-31.5, 20.25, -12.0]), sto_xyz=_affine(5, [10.0, -20.0, 30.0]),
    ),
}
HEADER_LINES = 6  # version, 3 comments, count, legend


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("volumes")
    paths = {}
    for name, write in VOLUMES.items():
        paths[name] = str(d / f"{name}.nii")
        write(paths[name])
    return paths


def run_both(flag, vol_path, tmp_path, monkeypatch):
    """Run the JAX CLI and the port's (on the CPU) with `flag`, each in its
    own working directory; returns the two directories."""
    out = {}
    for who, run in (("jax", lambda a: jx_cli.main(a)), ("port", lambda a: tx_cli.main(a, device="cpu"))):
        out[who] = tmp_path / who
        out[who].mkdir()
        monkeypatch.chdir(out[who])
        assert run([flag, vol_path, "out.key"]) == 0, who
    return out["jax"], out["port"]


def compare_runs(jax_dir, port_dir, desc_equal=0.99):
    """The rules of the module docstring; returns the JAX run's rows."""
    want_lines = (jax_dir / "out.key").read_text().splitlines()
    got_lines = (port_dir / "out.key").read_text().splitlines()
    assert got_lines[:HEADER_LINES] == want_lines[:HEADER_LINES]
    want, _ = keyfile.read_text(str(jax_dir / "out.key"))
    got, _ = keyfile.read_text(str(port_dir / "out.key"))
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.info, want.info)
    np.testing.assert_allclose(got.ori, want.ori, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.eigs, want.eigs, rtol=1e-4, atol=1e-6)
    same = float((got.desc == want.desc).all(axis=1).mean())
    print(f"{len(got)} rows, identical descriptors {same:.4f}")
    assert same >= desc_equal
    pgms = sorted(f for f in os.listdir(jax_dir) if f.endswith(".pgm"))
    assert pgms == sorted(f for f in os.listdir(port_dir) if f.endswith(".pgm"))
    for f in pgms:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
    return want


@pytest.mark.parametrize("flag, volume", [("-2+", "cube32"), ("-w", "aniso"), ("-ws", "aniso")])
def test_resampling_flags_match_jax(flag, volume, volumes, tmp_path, monkeypatch):
    jax_dir, port_dir = run_both(flag, volumes[volume], tmp_path, monkeypatch)
    want = compare_runs(jax_dir, port_dir)
    comment = (jax_dir / "out.key").read_text().splitlines()[3]
    if flag.startswith("-w"):
        assert ("sto_xyz" if flag == "-ws" else "qto_xyz") in comment
    assert "Voxel Resolution (ijk) : 64 64 64" in (port_dir / "out.key").read_text()
    print(f"{flag}: {len(want)} rows")


def test_halving_matches_jax_on_its_subsample(volumes, tmp_path, monkeypatch):
    """-2-: the port's own run against JAX's, printed; then the port fed
    the JAX package's eager subsample must meet every rule."""
    (tmp_path / "own").mkdir()
    jax_dir, port_dir = run_both("-2-", volumes["cube128"], tmp_path / "own", monkeypatch)
    want, _ = keyfile.read_text(str(jax_dir / "out.key"))
    own, _ = keyfile.read_text(str(port_dir / "out.key"))
    rep = (repeatability(own, want)[0], repeatability(want, own)[0])
    print(f"-2- own subsample: jax {len(want)} rows, port {len(own)}, repeatability {rep}")
    # one candidate flips (35 vs 36 rows): the only difference
    assert rep == (1.0, 1.0) and abs(len(own) - len(want)) <= 1

    def jax_subsample(t):
        return torch.from_numpy(np.array(jx_resample.subsample_2x(jnp.asarray(t.numpy()))))

    monkeypatch.setattr(tx_cli, "subsample_2x", jax_subsample)
    (tmp_path / "fed").mkdir()
    jax_dir, port_dir = run_both("-2-", volumes["cube128"], tmp_path / "fed", monkeypatch)
    compare_runs(jax_dir, port_dir)


@pytest.mark.parametrize("shape", [(128, 128, 128), (182, 218, 182)])
def test_subsample_order_witness(shape):
    """Where the -2- inputs part: JAX's eager 8-child mean equals the
    port's scan-order sum at 182x218x182 but, at 128^3, the tree
    ((((c0 + c1) + (c2 + c3)) + c4) + c5) + (c6 + c7) (XLA's CPU reduce
    picks its order per shape)."""
    vol = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jx_resample.subsample_2x(jnp.asarray(vol)))
    got = resample.subsample_2x(torch.from_numpy(vol)).numpy()
    if shape == (182, 218, 182):
        np.testing.assert_array_equal(got, want)
        return
    assert not np.array_equal(got, want)
    z, y, x = (s // 2 for s in shape)
    c = vol.reshape(z, 2, y, 2, x, 2).transpose(1, 3, 5, 0, 2, 4).reshape(8, z, y, x)
    tree = ((((c[0] + c[1]) + (c[2] + c[3])) + c[4]) + c[5]) + (c[6] + c[7])
    np.testing.assert_array_equal(tree / np.float32(8), want)


@pytest.mark.parametrize("flag", ["-d", "-dx", "-d0"])
def test_device_flag_is_accepted_as_the_jax_cli_accepts_it(flag, volumes, tmp_path, monkeypatch):
    """-d<N> picks the card; any other -d... means the default one, as the
    JAX CLI accepts and ignores every -d... The .key equals the call
    without the flag."""
    for who, args in (("plain", []), ("flag", [flag])):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        assert tx_cli.main([*args, volumes["cube64"], "out.key"], device="cpu") == 0, who
    assert (tmp_path / "flag" / "out.key").read_bytes() == (tmp_path / "plain" / "out.key").read_bytes()
    monkeypatch.chdir(tmp_path)
    assert jx_cli.main([flag, volumes["cube64"], "jax.key"]) == 0
