"""PyTorch port: package rules and kernel routing.

- No module under sift3d_torch/ imports jax, jaxlib or sift3d (the card's
  machine has no JAX; importing sift3d pulls it in).
- A CPU tensor takes every kernel wrapper's plain path, and never builds.
- Every ported kernel has its CUDA source.
- On a CUDA card (marker `cuda`, skipped without one), every kernel equals
  its plain version on the same tensors. This file imports no JAX, so it
  also runs where JAX is missing: python -m pytest --noconftest -m cuda
  tests/test_torch_package.py
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from sift3d_torch.kernels import cuda_lib, extrema_cuda, gauss, hist_cuda, patch_cuda

torch.set_num_threads(1)

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "sift3d_torch"
FORBIDDEN = {"jax", "jaxlib", "sift3d"}


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_never_imports_jax_or_the_jax_package():
    # the package's own sources; _build/ holds build outputs, not sources
    files = sorted(f for f in PACKAGE.rglob("*.py") if cuda_lib.BUILD_DIR not in f.parents)
    assert len(files) > 10
    bad = {
        str(f.relative_to(PACKAGE)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize(
    "source", ["dogs_extrema.cu", "sample_identity.cu", "hist_topk.cu", "sample_rotated.cu"]
)
def test_cuda_sources_exist(source):
    text = (PACKAGE / "csrc" / source).read_text()
    # each entry point is a plain C function returning cudaGetLastError()
    assert 'extern "C" int sift3d_' in text
    assert "Replaces the Pallas kernel" in text


def _inputs(rng):
    gs = torch.from_numpy(rng.standard_normal((6, 12, 14, 16)).astype(np.float32))
    r = 5
    lvl = torch.from_numpy(rng.integers(1, 4, r).astype(np.int32))
    centers = torch.from_numpy(rng.uniform(3, 10, (r, 3)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(1, 3, r).astype(np.float32))
    q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((r, 3, 3)).astype(np.float32)))
    e = rng.standard_normal((r, 40, 3)).astype(np.float32)
    xyz = e / np.linalg.norm(e, axis=-1, keepdims=True) * 5 + 5  # bin coordinates
    hist = [torch.from_numpy(np.ascontiguousarray(xyz[..., i])) for i in range(3)]
    hist.append(torch.from_numpy(rng.uniform(0, 1, (r, 40)).astype(np.float32)))
    band = torch.from_numpy(hist_cuda.hist_band(gauss.gaussian_kernel_1d(0.5, 0.01)))
    return gs, lvl, centers, scales, q.contiguous(), hist, band


def _calls(gs, lvl, centers, scales, oris, hist, band):
    return {
        "dogs_extrema": (extrema_cuda.dogs_extrema, extrema_cuda.dogs_extrema_plain, (gs,)),
        "sample_identity": (
            patch_cuda.sample_identity, patch_cuda.sample_identity_plain,
            (gs, lvl, centers, scales),
        ),
        "sample_rotated": (
            patch_cuda.sample_rotated, patch_cuda.sample_rotated_plain,
            (gs, lvl, centers, scales, oris),
        ),
        "hist_topk": (hist_cuda.hist_topk, hist_cuda.hist_topk_plain, (*hist, band, 6)),
    }


def _equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_tensors_take_the_plain_path_and_never_build(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "library", no_build)
    for name, (wrapper, plain, args) in _calls(*_inputs(rng)).items():
        before = wrapper.launches
        assert _equal(wrapper(*args), plain(*args)), name
        assert wrapper.launches == before, f"{name} counted a launch on the CPU"


def test_other_devices_raise(rng):
    gs = _inputs(rng)[0].to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        extrema_cuda.dogs_extrema(gs)


def test_library_path_is_keyed_on_the_sources():
    path = cuda_lib.library_path()
    assert path.parent.parent == cuda_lib.BUILD_DIR
    assert len(cuda_lib.sources()) >= 5  # four kernels + the shared header
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    gs, lvl, centers, scales, oris, hist, band = _inputs(rng)
    moved = [t.to(dev) for t in (gs, lvl, centers, scales, oris)]
    for name, (wrapper, plain, args) in _calls(
        *moved, [t.to(dev) for t in hist], band.to(dev)
    ).items():
        before = wrapper.launches
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert _equal(got, want), name
