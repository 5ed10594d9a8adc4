"""PyTorch port end to end against the JAX package on the CPU: the 64^3
cells, the two CLIs and the .key writer, and the carried-over state.

Exact parity cells (64^3): XLA's CPU dots sum the blur taps in the port's
order at these shapes, so both pipelines see the same pyramid: equal
counts, repeatability 1.0 both ways, location and scale within 1e-4, equal
flags, descriptors identical on >= 99% of rows, and .key files from the
two CLIs that differ at most in the last printed digit of orientations and
eigenvalues. Orientations agree within 1e-3: the identity patches differ
from the JAX package's in the last bit (XLA's CPU dot emitter contracts
the boxed sampler's 2-tap weights in an order no fixed multiply-add
sequence reproduces), and an eigenvector of a nearly degenerate structure
tensor amplifies that. The 48^3 cells are in test_torch_extract_48.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sift3d.cli import featextract as jx_cli
from sift3d.core.config import SiftConfig as JxConfig
from sift3d.kernels import descriptor as jx_descriptor
from sift3d.kernels import gauss as jx_gauss
from sift3d.kernels import patch as jx_patch
from sift3d.io import keyfile as jx_keyfile
from sift3d.pipeline.extract import extract_features as jx_extract
from sift3d_torch.cli import featextract as tx_cli
from sift3d_torch.core.config import from_numpy_state, static_table
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT
from sift3d_torch.io import keyfile, nifti
from sift3d_torch.kernels.patch import rbox_max_scale
from sift3d_torch.pipeline.extract import extract_features, extract_octaves
from sift3d_torch.utils.synthetic import repeatability, synthetic_blob_texture, synthetic_volume

torch.set_num_threads(1)


EXACT_CELLS = {
    "synthetic64_s3": lambda: synthetic_volume(64, seed=3),
    "synthetic64_s7": lambda: synthetic_volume(64, seed=7),
    "texture64": lambda: synthetic_blob_texture((64, 64, 64), seed=7, n_blobs=30),
}


@pytest.mark.parametrize("cell", sorted(EXACT_CELLS))
def test_extract_matches_jax_exactly(cell):
    vol = EXACT_CELLS[cell]()
    want = jx_extract(vol, JxConfig())
    got = extract_features(vol, device="cpu")
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ori, want.ori, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.eigs, want.eigs, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.info, want.info)
    assert (got.desc == want.desc).all(axis=1).mean() >= 0.99
    # boxless rotated patches equal the JAX boxed ones only below the
    # 64^3 box's scale bound; no emitted row reaches it at these sizes
    over = sum(
        int((((rows["info"] & INFO_FLAG_REORIENT) != 0) & (rows["scale"] > rbox_max_scale(64))).sum())
        for _, rows in extract_octaves(vol, device="cpu")
    )
    print(f"{cell}: {len(got)} features, reoriented rows above scale 8.80: {over}")
    assert over == 0


def test_cli_key_files_match(tmp_path):
    """The two CLIs' .key files: identical headers, counts, locations,
    scales, flags and descriptors; orientation and eigenvalue text within
    1e-5 (their last printed digit can differ: XLA's and PyTorch's cos,
    arccos and 1331-term sums round differently)."""
    vol_path = str(tmp_path / "v.nii")
    nifti.write(vol_path, synthetic_volume(64, seed=7))
    assert jx_cli.main([vol_path, str(tmp_path / "jax.key")]) == 0
    assert tx_cli.main([vol_path, str(tmp_path / "port.key")], device="cpu") == 0
    want = (tmp_path / "jax.key").read_text().splitlines()
    got = (tmp_path / "port.key").read_text().splitlines()
    assert len(got) == len(want) > 5
    assert got[:5] == want[:5]  # header, comments, count, legend
    rows_got = [line.split("\t") for line in got[5:]]
    rows_want = [line.split("\t") for line in want[5:]]
    for g, w in zip(rows_got, rows_want):
        assert g[:4] == w[:4] and g[16:] == w[16:]  # x y z scale | info, descriptor
        np.testing.assert_allclose(
            np.float64(g[4:16]), np.float64(w[4:16]), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("eig_threshold", [-1.0, 140.0])
def test_key_writer_matches_jax_bytes(tmp_path, eig_threshold):
    """The port's .key writer and the JAX package's (its C++ fast path and
    its Python writer) write the same bytes for the same FeatureSet."""
    feats = extract_features(synthetic_volume(48, seed=7), device="cpu")
    comments = ["Extraction Voxel Resolution (ijk) : 48 48 48", "a comment"]
    keyfile.write_text(feats, str(tmp_path / "port.key"), eig_threshold, comments)
    for native in (True, False):
        path = tmp_path / f"jax_{native}.key"
        jx_keyfile.write_text(feats, str(path), eig_threshold, comments, use_native=native)
        assert path.read_bytes() == (tmp_path / "port.key").read_bytes()
    back, got_comments = keyfile.read_text(str(tmp_path / "port.key"))
    assert got_comments[1:] == comments
    np.testing.assert_allclose(back.xyz, feats.select(feats.eig_mask(eig_threshold)).xyz, atol=1e-6)


@pytest.mark.parametrize("flag, message", [
    ("--spatial=x", "unknown command line argument"),
    ("--spatial-octaves", "unknown command line argument"),
    ("--spatial-octaves=two", "unknown command line argument"),
    ("-s", "unknown command line argument"), ("-x", "unknown command line argument"),
])
def test_cli_refuses_flags_outside_the_slice(tmp_path, capsys, flag, message):
    """Every flag of the JAX CLI is ported (--spatial with it); a malformed
    --spatial flag or an unknown flag is refused as the JAX CLI refuses an
    unknown one."""
    assert tx_cli.main([flag, "in.nii", str(tmp_path / "out.key")]) == -1
    assert message in capsys.readouterr().out


def test_cli_runs_on_the_card(tmp_path, monkeypatch):
    """With no device argument the CLI extracts on cuda:<N> (-d<N>, default
    0) and raises when there is no CUDA card; it never falls back to the
    CPU."""
    vol_path = str(tmp_path / "v.nii")
    nifti.write(vol_path, synthetic_volume(16, seed=1))
    seen = []

    def fake_resolve(device=None, like=None):
        # record the device the CLI asks for; run on the CPU
        seen.append(str(device))
        return torch.device("cpu")

    def fake_extract(data, cfg, device, timer, **kwargs):
        assert data.device == device == torch.device("cpu")
        assert kwargs == dict(prescale=None, descriptor="goh", on_gstack=None)
        return extract_features(data, cfg, device=device, timer=timer, **kwargs)

    monkeypatch.setattr(tx_cli, "resolve_device", fake_resolve)
    monkeypatch.setattr(tx_cli, "extract_features", fake_extract)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tx_cli.main([vol_path, str(tmp_path / "a.key")]) == 0
    assert tx_cli.main(["-d1", vol_path, str(tmp_path / "b.key")]) == 0
    assert seen == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx_cli.main([vol_path, str(tmp_path / "c.key")])
    assert seen == ["cuda:0", "cuda:1"]


def test_from_numpy_state_tables_equal_jax():
    cfg = JxConfig()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    incs = cfg.incremental_sigmas()
    initial = float(np.sqrt(cfg.sigma_base**2 - cfg.sigma_init**2))
    tables = {
        "taps/initial": jx_gauss.gaussian_kernel_1d(initial, cfg.blur_precision),
        "taps/ori_hist": jx_gauss.gaussian_kernel_1d(cfg.ori_hist_blur_sigma, 0.01),
        "level_sigmas": np.asarray(cfg.level_sigmas(), np.float32),
        "patch_grid": jx_patch._GRID,
        "sphere_mask": jx_patch.sphere_mask(),
        "ori_dirs": jx_descriptor._ORI_DIRS,
        "spatial_weights": jx_descriptor._spatial_weight_table(),
    }
    for j, s in enumerate(incs, 1):
        tables[f"taps/level{j}"] = jx_gauss.gaussian_kernel_1d(s, cfg.blur_precision)
        for dim in (182, 218, 91):
            tables[f"band/level{j}/{dim}"] = jx_gauss._banded_matrix(dim, s, cfg.blur_precision)
    tables["band/initial/182"] = jx_gauss._banded_matrix(182, initial, cfg.blur_precision)
    port_cfg = from_numpy_state(fields, tables)
    shared = dataclasses.asdict(port_cfg)
    assert shared and shared == {k: v for k, v in fields.items() if k in shared}
    for name in ("dtype", "patch_dim"):  # a field the port does not read, set away from its default
        with pytest.raises(ValueError, match=name):
            from_numpy_state(dict(fields, **{name: {"dtype": "bfloat16", "patch_dim": 13}[name]}), {})
    for name, want in tables.items():
        got = static_table(name, port_cfg)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    bad = dict(tables, **{"taps/level1": tables["taps/level1"] * 1.0001})
    with pytest.raises(ValueError, match="taps/level1"):
        from_numpy_state(fields, bad)
