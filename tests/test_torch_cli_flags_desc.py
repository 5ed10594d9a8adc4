"""PyTorch port: the descriptor flags (-b, -br, -bn) and --debug-pgm
against the JAX CLI on the CPU, at 64^3. The rules, the volumes and the
runners are test_torch_cli_flags.py's; this file holds the other half of
the flags so that xdist's --dist loadfile spreads the two.
"""

import pytest
import torch

from test_torch_cli_flags import compare_runs, run_both, volumes  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("flag", ["-b", "-br", "-bn"])
def test_descriptor_flags_match_jax(flag, volumes, tmp_path, monkeypatch):  # noqa: F811
    jax_dir, port_dir = run_both(flag, volumes["cube64"], tmp_path, monkeypatch)
    compare_runs(jax_dir, port_dir)


def test_debug_pgm_matches_jax(volumes, tmp_path, monkeypatch):  # noqa: F811
    """The same PGM files (image.pgm and one image_o<N>.pgm per octave),
    byte for byte, and the same .key rows."""
    jax_dir, port_dir = run_both("--debug-pgm", volumes["cube64"], tmp_path, monkeypatch)
    compare_runs(jax_dir, port_dir)
    names = sorted(p.name for p in port_dir.glob("*.pgm"))
    assert names == ["image.pgm"] + [f"image_o{i}.pgm" for i in range(5)]
    assert (port_dir / "image.pgm").read_bytes().startswith(b"P5\n64 64\n255\n")
