"""PyTorch port: package rules and kernel routing.

- No module under sift3d_torch/ imports jax, jaxlib or sift3d (the card's
  machine has no JAX; importing sift3d pulls it in), nor do chip_smoke.py
  and scripts/torch_multihost_worker.py.
- The kernel library loads once when many threads ask for it at once, and
  the launch counts lose no update under threads (dist.batch runs one host
  thread per mesh entry).
- The plain versions take zero rows (an octave whose candidates have no
  live primary orientation).
- A CPU tensor takes every kernel wrapper's plain path, and never builds.
- Every ported kernel has its CUDA source, the matching kernels (M1 kNN,
  M2 ratio test, M3 Hough scores and inlier masks) too.
- On a CUDA card (marker `cuda`, skipped without one), every kernel equals
  its plain version on the same tensors (M2 on both routes at its edge
  shapes, the fused BRIEF kernels on edge rows and patches); the blur (K7)
  equals its plain
  version run on the CPU (cuBLAS on the card sums in another order); the
  batched calls of batched extraction (K1 on [B, 6, Z, Y, X], the fused K2
  with a volume index, the fused K4 and K4's patch mode on the flattened
  [B * 6, Z, Y, X] stack) equal per-volume calls of the same kernels, and
  the sharded kNN and solve over three entries of the card equal the
  single-device calls. This file imports no JAX, so it
  also runs where JAX is missing: python -m pytest --noconftest -m cuda
  tests/test_torch_package.py
"""

import ast
import pathlib
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.dist import gather, solve
from sift3d_torch.kernels import cuda_lib, extrema_cuda, gauss, gauss_cuda, hist_cuda, knn_cuda, patch, patch_cuda
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.match import hough, pairwise
from sift3d_torch.match.knn import knn_search
from sift3d_torch.match.solve import solve_similarity
from sift3d_torch.pipeline import features

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sift3d_torch"
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
    assert {"mesh.py", "halo.py", "spatial.py", "batch.py", "gather.py", "solve.py", "multihost.py"} <= {
        f.name for f in files if f.parent.name == "dist"
    }
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "torch_multihost_worker.py"]
    bad = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize(
    "source", ["dogs_extrema.cu", "hist_topk.cu", "sample_rotated.cu", "blur3d.cu", "identity_eig.cu",
               "rotated_goh.cu", "rotated_brief.cu"]
)
def test_cuda_sources_exist(source):
    text = (PACKAGE / "csrc" / source).read_text()
    # each entry point is a plain C function returning cudaGetLastError()
    assert 'extern "C" int sift3d_' in text
    assert "Replaces the Pallas kernel" in text


@pytest.mark.parametrize("source", ["knn_topk.cu", "ratio_match.cu", "hough_scores.cu"])
def test_matching_sources_exist(source):
    text = (PACKAGE / "csrc" / source).read_text()
    assert 'extern "C" int sift3d_' in text
    # the JAX package computes matching in XLA and numpy, not in Pallas
    assert "Not a Pallas kernel in the JAX package" in text and "Replaces the" in text


@pytest.mark.parametrize("entry", sorted(cuda_lib.SIGNATURES))
def test_every_c_entry_has_its_source(entry):
    text = "".join(src.read_text() for src in cuda_lib.sources())
    assert f'extern "C" int {entry}(' in text


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


def _candidates(gs):
    """The fused K2's inputs on gs: DoGs of uniform [0, 1) with each
    candidate voxel raised to 2 on its level (a strict peak, so the
    refinement stays near the voxel), its levels around it to 1.5."""
    dogs = torch.rand(5, *gs.shape[1:], generator=torch.Generator().manual_seed(3))
    zyx = torch.tensor([[3, 4, 5], [6, 7, 8], [8, 9, 12], [5, 10, 4]])
    lvl = torch.tensor([1, 2, 3, 2])
    for (z, y, x), lv in zip(zyx.tolist(), lvl.tolist()):
        dogs[lv, z, y, x] = 2.0
        dogs[lv - 1, z, y, x] = dogs[lv + 1, z, y, x] = 1.5
    return dogs.to(gs.device), lvl.to(gs.device), zyx.to(gs.device)


def _match_inputs(device):
    """Inputs of M1-M3 on `device`: rank rows with repeats (tied
    distances), 67-column rows with float geometry, a database with
    positions and scales, and 40 matches of a noisy similarity."""
    rng = np.random.default_rng(7)
    ranks = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (60, 1)), axis=1)
    db = np.concatenate([ranks, ranks[:20]])
    q = np.concatenate([ranks[rng.integers(0, 60, 10)], rng.integers(0, 64, (15, 64)).astype(np.float32)])
    geo = rng.uniform(0, 20, (80, 3)).astype(np.float32)
    xyz = rng.uniform(0, 30, (80, 3)).astype(np.float32)
    scale = rng.uniform(2, 6, 80).astype(np.float32)
    o0, _ = np.linalg.qr(rng.standard_normal((40, 3, 3)))
    o1 = (o0 + rng.normal(0, 0.2, o0.shape)).astype(np.float32)
    p0 = rng.uniform(0, 40, (40, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(0, 2, p0.shape)).astype(np.float32)
    s0 = rng.uniform(2, 6, 40).astype(np.float32)
    s1 = (s0 * np.exp(rng.normal(0, 0.5, 40))).astype(np.float32)

    def put(*arrays):
        return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(device) for a in arrays]

    return dict(
        knn=(*put(q, db), 5),
        knn67=(*put(np.concatenate([q, geo[:25]], 1), np.concatenate([db, geo], 1)), 9),
        knn_f32=(*put(q * 0.37, db * 0.37), 5),
        ratio=(*put(q, db, xyz, scale), float(np.float32(np.log(1.5))), 0.5),
        ratio_f32=(*put(q * 0.37, db * 0.37, xyz, scale), float(np.float32(np.log(1.5))), 0.5),
        hough=(*put(p0, p1, s0, s1, o0, o1), (1.0, 2.0, float(np.float32(0.7)))),
    )


# the C entries (cuda_lib.SIGNATURES) one call of each of _calls launches,
# once each: M1's int8 route its pre-pass and its main kernel (one slice at
# these sizes), M2's int8 route M1's pre-pass and its own kernel, M3's
# scores and inlier masks the one entry's two modes
KNN_I8, HOUGH = ("sift3d_knn_prep_i8", "sift3d_knn_topk_i8"), ("sift3d_hough",)
ENTRIES = {
    "knn_topk": KNN_I8, "knn_topk_geometry": KNN_I8, "knn_topk_f32": ("sift3d_knn_topk",),
    "ratio_rows": ("sift3d_knn_prep_i8", "sift3d_ratio_match_i8"), "ratio_rows_f32": ("sift3d_ratio_match",),
    "hough_scores": HOUGH, "hough_scores_stacked": HOUGH, "hough_inliers": HOUGH, "hough_inliers_one_pair": HOUGH,
    "gather_eig": ("sift3d_identity_eig",), "rotated_goh": ("sift3d_rotated_goh",), "goh": ("sift3d_goh",),
    "rotated_brief": ("sift3d_rotated_brief",), "rotated_rrief": ("sift3d_rotated_brief",),
    "rotated_nrrief": ("sift3d_rotated_brief",), "brief": ("sift3d_brief",),
    "dogs_extrema": ("sift3d_dogs_extrema",), "sample_rotated": ("sift3d_sample_rotated",),
    "extrema_mask": ("sift3d_extrema_mask",), "extrema_mask_batch": ("sift3d_extrema_mask",),
    "hist_topk": ("sift3d_hist_topk",), "splat_histogram_raw": ("sift3d_splat_histogram_raw",),
    "smooth_histogram_peaks": ("sift3d_smooth_histogram_peaks",),
    "blur3d": ("sift3d_blur3d",), "blur3d_batch": ("sift3d_blur3d",),
}


def _counts() -> dict:
    """Every C entry's launches so far (cuda_lib's count), but the
    occupancy query's, which knn_cuda.int8_places makes once a shape."""
    return {e: launches(e) for e in cuda_lib.SIGNATURES if e != "sift3d_knn_i8_blocks_per_sm"}


def _launched(before: dict) -> dict:
    """{entry: launches since before} of the entries that launched."""
    now = _counts()
    return {e: now[e] - before[e] for e in now if now[e] != before[e]}


def _calls(gs, lvl, centers, scales, oris, hist, band):
    cfg = SiftConfig()
    m = _match_inputs(gs.device)
    return {
        "knn_topk": (knn_cuda.knn_topk_int8, knn_cuda.knn_topk_plain, m["knn"]),
        "knn_topk_geometry": (knn_cuda.knn_topk_int8, knn_cuda.knn_topk_plain, m["knn67"]),
        "knn_topk_f32": (knn_cuda.knn_topk_f32, knn_cuda.knn_topk_plain, m["knn_f32"]),
        "ratio_rows": (pairwise.ratio_rows_int8, pairwise.ratio_rows_plain, m["ratio"]),
        "ratio_rows_f32": (pairwise.ratio_rows_f32, pairwise.ratio_rows_plain, m["ratio_f32"]),
        "hough_scores": (hough.hough_scores, hough.hough_scores_plain, m["hough"]),
        "hough_scores_stacked": (hough.hough_scores, hough.hough_scores_plain, (*m["hough"], [0, 15, 15, 40])),
        "hough_inliers": (hough.hough_inliers, hough.hough_inliers_plain, (*m["hough"], [0, 15, 40], [3, 20])),
        "hough_inliers_one_pair": (hough.hough_inliers, hough.hough_inliers_plain, (*m["hough"], None, [7])),
        "gather_eig": (
            features.gather_eig, features.gather_eig_plain,
            (gs, *_candidates(gs), tuple(cfg.level_sigmas()), cfg),
        ),
        "rotated_goh": (
            patch_cuda.rotated_goh, patch_cuda.rotated_goh_plain, (gs, lvl, centers, scales, oris),
        ),
        "goh": (patch_cuda.goh, patch_cuda.goh_plain, (gs[:, :11, :11, :11].contiguous(),)),
        **{f"rotated_{v}": (patch_cuda.rotated_brief, patch_cuda.rotated_brief_plain,
                            (gs, lvl, centers, scales, oris, 0, None, v, 2)) for v in ("brief", "rrief", "nrrief")},
        "brief": (patch_cuda.brief, patch_cuda.brief_plain, (gs[:, :11, :11, :11].contiguous(), "nrrief", 4)),
        "dogs_extrema": (extrema_cuda.dogs_extrema, extrema_cuda.dogs_extrema_plain, (gs,)),
        "sample_rotated": (
            patch_cuda.sample_rotated, patch_cuda.sample_rotated_plain,
            (gs, lvl, centers, scales, oris),
        ),
        "extrema_mask": (extrema_cuda.extrema_mask, extrema_cuda.extrema_mask_plain, (gs[1:],)),
        "extrema_mask_batch": (
            extrema_cuda.extrema_mask, extrema_cuda.extrema_mask_plain,
            (torch.stack([gs[1:], gs[:-1]]),),
        ),
        "hist_topk": (hist_cuda.hist_topk, hist_cuda.hist_topk_plain, (*hist, band, 6)),
        "splat_histogram_raw": (
            hist_cuda.splat_histogram_raw_bins, hist_cuda.splat_histogram_raw_plain, tuple(hist),
        ),
        "smooth_histogram_peaks": (
            hist_cuda.smooth_histogram_peaks_bins, hist_cuda.smooth_histogram_peaks_plain, (*hist, band),
        ),
        # one volume at the widest pyramid radius, and a batch at BRIEF's
        "blur3d": (gauss_cuda.blur3d, gauss.blur3d, (gs[0], 3.0897, 0.01)),
        "blur3d_batch": (gauss_cuda.blur3d, gauss.blur3d, (gs, 0.95, 0.01)),
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
    calls = _calls(*_inputs(rng))
    assert set(calls) == set(ENTRIES)
    for name, (wrapper, plain, args) in calls.items():
        before = _counts()
        assert _equal(wrapper(*args), plain(*args)), name
        assert _launched(before) == {}, f"{name} counted a launch on the CPU"


def test_other_devices_raise(rng):
    gs = _inputs(rng)[0].to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        extrema_cuda.dogs_extrema(gs)
    with pytest.raises(ValueError, match="no kernel for device"):
        gauss_cuda.blur3d(gs[0], 1.2, 0.01)


def test_library_path_is_keyed_on_the_sources():
    path = cuda_lib.library_path()
    assert path.parent.parent == cuda_lib.BUILD_DIR
    assert len(cuda_lib.sources()) >= 7  # six kernel sources + the shared header
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)


def test_library_loads_once_from_many_threads(monkeypatch):
    """8 threads ask for the library at once, the build slow: one build, one
    library, and every thread gets it."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return pathlib.Path("libfake.so")

    class FakeLib:
        def __init__(self, path):
            self.path = path
            for name in cuda_lib.SIGNATURES:
                setattr(self, name, type("Entry", (), {})())

    monkeypatch.setattr(cuda_lib, "build", slow_build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", FakeLib)
    cuda_lib._load.cache_clear()
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(cuda_lib.library())) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)
        assert got[0].path == "libfake.so"
    finally:
        cuda_lib._load.cache_clear()


def test_launch_counts_lose_no_update_under_threads(monkeypatch):
    """16 threads launch one entry 2000 times each through cuda_lib.launch
    (a library whose entries return 0 on a stand-in stream): every launch is
    counted, under that entry's name alone."""
    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(cuda_lib, "library", FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("Stream", (), {"cuda_stream": 0}))
    dev = torch.device("cuda:0")
    before = _counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_lib.launch("sift3d_goh", 0, 0, 0, device=dev)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _launched(before) == {"sift3d_goh": 16 * 2000}


def test_plain_versions_take_zero_rows():
    band = torch.from_numpy(hist_cuda.hist_band(gauss.gaussian_kernel_1d(0.5, 0.01)))
    empty = torch.zeros((0, 40))
    assert hist_cuda.hist_topk(empty, empty, empty, empty, band, 3).shape == (0, 3, 16)
    assert patch.normalize_patches(torch.zeros((0, 11, 11, 11))).shape == (0, 11, 11, 11)
    assert patch_cuda.goh(torch.zeros((0, 11, 11, 11))).shape == (0, 64)


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
        before = _counts()
        got = wrapper(*args)
        # read before the plain version runs: on the card some call kernels
        # (the BRIEF pre-blur is K7)
        launched = _launched(before)
        if name.startswith("blur3d"):
            want = plain(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
            got = got.cpu()
        else:
            want = plain(*args)
        torch.cuda.synchronize()
        assert launched == dict.fromkeys(ENTRIES[name], 1), name
        assert _equal(got, want), name


@pytest.mark.cuda
def test_batched_kernels_match_per_volume_calls_on_the_card(rng):
    """K1 on a batch of three stacks, the fused K2 on their candidate union
    (volume index vi) and the fused K4 / K4's patch mode on the flattened
    [3 * 6, Z, Y, X] stack: one launch each, equal to the plain version on
    the same tensors and to per-volume launches of the same kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    cfg = SiftConfig()
    sig = tuple(cfg.level_sigmas())
    gs, _, centers, scales, oris, _, _ = _inputs(rng)
    batch = torch.stack([gs, gs.flip(1), gs * 0.5]).to(dev).contiguous()
    before = _counts()
    dogs, mask = extrema_cuda.dogs_extrema(batch)
    assert _launched(before) == {"sift3d_dogs_extrema": 1}
    assert _equal((dogs, mask), extrema_cuda.dogs_extrema_plain(batch))
    for b in range(3):
        assert _equal((dogs[b], mask[b]), extrema_cuda.dogs_extrema(batch[b].contiguous()))
    # the fused K2 on _candidates' rows in each volume, as one union
    cdogs, lvl, zyx = _candidates(gs)
    cdogs = torch.stack([cdogs, cdogs.flip(1), cdogs * 2.0]).to(dev).contiguous()
    vi = torch.arange(3).repeat_interleave(lvl.shape[0]).to(dev)
    lvl, zyx = lvl.repeat(3).to(dev), zyx.repeat(3, 1).to(dev)
    before = _counts()
    got = features.gather_eig(batch, cdogs, lvl, zyx, sig, cfg, vi=vi)
    assert _launched(before) == {"sift3d_identity_eig": 1}
    assert _equal(got, features.gather_eig_plain(batch, cdogs, lvl, zyx, sig, cfg, vi=vi))
    for b in range(3):
        sel = vi == b
        want = features.gather_eig(batch[b].contiguous(), cdogs[b].contiguous(), lvl[sel], zyx[sel], sig, cfg)
        assert _equal(tuple(t[sel] for t in got), want)
    # the fused K4 and K4's patch mode: volume vi's level l is level 6 vi + l
    r = centers.shape[0]
    rvi = torch.from_numpy(rng.integers(0, 3, r)).to(dev)
    rlvl = torch.from_numpy(rng.integers(1, 4, r)).to(dev)
    rows = [t.to(dev) for t in (centers, scales, oris)]
    flat = batch.flatten(0, 1)
    glvl = (rvi * 6 + rlvl).to(torch.int32)
    for wrapper, plain, entry in (
            (patch_cuda.rotated_goh, patch_cuda.rotated_goh_plain, "sift3d_rotated_goh"),
            (patch_cuda.rotated_brief, patch_cuda.rotated_brief_plain, "sift3d_rotated_brief"),
            (patch_cuda.sample_rotated, patch_cuda.sample_rotated_plain, "sift3d_sample_rotated")):
        before = _counts()
        got = wrapper(flat, glvl, *rows)
        assert _launched(before) == {entry: 1}
        assert _equal(got, plain(flat, glvl, *rows))
        for b in range(3):
            sel = rvi == b
            want = wrapper(batch[b].contiguous(), rlvl[sel].to(torch.int32), *(t[sel] for t in rows))
            assert _equal(got[sel], want)


@pytest.mark.cuda
def test_sharded_knn_and_solve_on_the_card(rng):
    """Over three entries of cuda:0: M1 once per entry (its int8 route: the
    pre-pass and the main kernel), equal to one call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = ["cuda:0"] * 3
    q, db, k = _match_inputs(torch.device("cuda:0"))["knn"]
    want = knn_search(q, db, k)
    before = _counts()
    got = gather.sharded_knn(q, db, k, mesh)
    assert _launched(before) == dict.fromkeys(ENTRIES["knn_topk"], 3)
    assert _equal(got, want)
    p, q = (rng.uniform(-10, 10, (1000, 3)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.5, 1.5, 1000).astype(np.float32)
    want = solve_similarity(p, q, w, device="cuda:0")
    got = solve.solve_similarity_sharded(p, q, w, mesh)
    assert got[0] == want[0] and np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


def _tie_rows(rng, n, d, device):
    """M2's edge inputs: n queries against d database rows of a 3-letter
    alphabet (distances tie heavily), a third of the database repeated, on
    positions close enough that the partner changes inside a tile and many
    events are compatible."""
    db = rng.integers(0, 3, (d, 64)).astype(np.float32)
    db[d // 3 : 2 * (d // 3)] = db[: d // 3]
    q = np.concatenate([db[rng.integers(0, d, n // 2)], rng.integers(0, 3, (n - n // 2, 64))]).astype(np.float32)
    xyz = rng.uniform(0, 4, (d, 3)).astype(np.float32)
    scale = rng.uniform(2, 4, d).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, db, xyz, scale)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 127, 128, 129, 969, 9000])
def test_ratio_match_routes_at_their_edges_on_the_card(d):
    """M2 on both routes against its plain version on tie-heavy rows at D
    in {2, 3, 127, 128, 129, 969} (tiles and halves cut mid-way) and 9000
    (more rows than the int8 kernel keeps geometry for in shared memory);
    the int8 route two launches a call, the f32 route one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(d)
    q, db, xyz, scale = _tie_rows(rng, 300, d, torch.device("cuda:0"))
    thr = float(np.float32(np.log(1.5)))
    for wrapper, rows, entries in ((pairwise.ratio_rows_int8, (q, db), ENTRIES["ratio_rows"]),
                                   (pairwise.ratio_rows_f32, (q * 0.37, db * 0.37), ENTRIES["ratio_rows_f32"])):
        before = _counts()
        got = wrapper(*rows, xyz, scale, thr, 0.5)
        torch.cuda.synchronize()
        assert _launched(before) == dict.fromkeys(entries, 1)
        assert _equal(got, pairwise.ratio_rows_plain(*rows, xyz, scale, thr, 0.5)), wrapper.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["brief", "rrief", "nrrief"])
def test_fused_brief_at_its_edges_on_the_card(rng, variant):
    """The fused BRIEF kernels against their plain versions: rows reaching
    outside the volume in x, at scales above 8.80, on a NaN level (NaN
    patches), from a Z slab, every pair table; given patches that are zero,
    constant, mirrored (tied values) or NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    gs = torch.from_numpy(rng.standard_normal((6, 40, 24, 28)).astype(np.float32)).to(dev)
    gs[5] = float("nan")
    n = 24
    lvl = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)).to(dev)
    centers = torch.from_numpy(rng.uniform(-2, 30, (n, 3)).astype(np.float32)).to(dev)
    centers[:, 2] = torch.from_numpy(rng.uniform(14, 26, n).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(1, 12, n).astype(np.float32)).to(dev)
    q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, 3, 3)).astype(np.float32)))
    oris = q.contiguous().to(dev)
    patches = torch.from_numpy(rng.standard_normal((6, 11, 11, 11)).astype(np.float32)).to(dev)
    patches[0] = 0.0
    patches[1] = 2.0
    patches[2] = (torch.arange(11, device=dev) - 5.0).abs()
    patches[3] = float("nan")
    for method in range(5):
        for g, z0 in ((gs, 0), (gs[:, 8:34].contiguous(), 8)):
            small = scales.clamp(max=2.0) if z0 else scales
            args = (g, lvl, centers, small, oris, z0, 40, variant, method)
            before = _counts()
            got = patch_cuda.rotated_brief(*args)
            assert _launched(before) == {"sift3d_rotated_brief": 1}
            assert _equal(got, patch_cuda.rotated_brief_plain(*args)), (method, z0)
        assert _equal(patch_cuda.brief(patches, variant, method), patch_cuda.brief_plain(patches, variant, method))


def test_native_io_is_the_ports_own():
    """The .key I/O library is built from the port's own csrc/key_text.cpp
    into its _build/; no port file names the JAX package's native/
    directory or its library."""
    from sift3d_torch.io import native

    assert native.SOURCE == PACKAGE / "csrc" / "key_text.cpp"
    assert native.BUILD_DIR == cuda_lib.BUILD_DIR and native.BUILD_DIR in native.library_path().parents
    files = [f for f in PACKAGE.rglob("*") if f.suffix in (".py", ".cu", ".cuh", ".cpp")
             and cuda_lib.BUILD_DIR not in f.parents]
    files.append(REPO / "chip_smoke.py")
    assert [str(f) for f in files if re.search(r"sift3d_native|\bnative/", f.read_text())] == []
