"""PyTorch port: featExtract's -w on the extraction entry points (prescale
"isotropic" on Scans) and the batched resample kernel.

On the CPU:
- the CPU route of ``isotropic_resample_batch`` (the kernel's plain twin:
  the plain chain ``resample.isotropic_resample`` volume by volume) fills
  the grid of ``resample.isotropic_shape`` with the chain's bits, on odd,
  even and length-1 axes, at factors 1.25, 1.28 (1.2 / 0.9375), 1.5 and
  3.0, with the smallest voxel size on each axis in turn, and on NaN,
  infinities and signed zeros;
- ``extract_features_many(..., prescale="isotropic")`` on a batch of mixed
  voxel sizes (two of one shape and voxel size, one of that shape at
  another, one of another shape, one of cubic voxels under -ws' sform)
  equals ``featextract -w`` / ``-ws`` one volume at a time, bit for bit,
  and so do ``extract_features`` and ``extract_features_batch``;
- the planner plans on the resampled grid, and the span ``resample`` and
  the counters ``resampled_volumes`` and ``resampled_bytes`` count the
  resampled volumes (``featextract -w --time`` prints them);
- the routes that take no isotropic mode raise.
On the card (``cuda``): ``csrc/isotropic_resample.cu`` equals the plain
chain on the card at [32, 128, 256, 256] and at edge shapes, one launch a
call.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sift3d_torch.cli import featextract as tx_cli
from sift3d_torch.dist.batch import extract_features_batch
from sift3d_torch.dist.spatial import extract_features_spatial
from sift3d_torch.io import nifti
from sift3d_torch.kernels import resample, resample_cuda
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.pipeline import extract
from sift3d_torch.pipeline.extract import Scan, extract_features, extract_features_many
from sift3d_torch.utils.synthetic import synthetic_volume
from sift3d_torch.utils.timing import TRACER

torch.set_num_threads(1)
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
OASIS = (128, 256, 256)
OASIS_MM = (1.0, 1.0, 1.25)


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in FIELDS)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other is NaN, and equal bits (the sign
    of a zero, infinities) everywhere else."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def _affine(seed, voxel_size, offset):
    m = np.eye(4)
    m[:3, :3] = _rotation(seed) * np.asarray(voxel_size, np.float64)
    m[:3, 3] = offset
    return m


# the smallest voxel size on each axis in turn, at each factor d / min
FACTORS = [(1.0, 1.25), (0.9375, 1.2), (1.0, 1.5), (1.0, 3.0)]
VOXEL_SIZES = [tuple(lo if a == k else hi for a in range(3)) for lo, hi in FACTORS for k in range(3)]
SHAPES = [(5, 6, 7), (4, 6, 8), (1, 6, 7), (5, 1, 7), (5, 6, 1), (1, 1, 1)]


@pytest.mark.parametrize("voxel_size", VOXEL_SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernels_plain_twin_equals_the_plain_chain(shape, voxel_size):
    rng = np.random.default_rng(sum(shape))
    batch = torch.from_numpy((100 * rng.standard_normal((2,) + shape)).astype(np.float32))
    grid = resample.isotropic_shape(shape, voxel_size)
    out = torch.full((2,) + grid, float("nan"))
    assert resample_cuda.isotropic_resample_batch(batch, out, voxel_size) is out
    for b in range(2):
        want, dmin = resample.isotropic_resample(batch[b], voxel_size)
        assert dmin == min(voxel_size) and tuple(want.shape) == grid
        assert _bits_equal(out[b], want), (shape, voxel_size, b)


def test_the_twin_carries_nan_infinities_and_signed_zeros_as_the_chain_does():
    rng = np.random.default_rng(4)
    vol = (100 * rng.standard_normal((6, 7, 8))).astype(np.float32)
    vol.flat[rng.choice(vol.size, 40, replace=False)] = [np.nan, np.inf, -np.inf, -0.0, 0.0] * 8
    batch = torch.from_numpy(vol)[None]
    for voxel_size in ((1.0, 1.0, 1.25), (1.5, 1.0, 1.0), (1.0, 1.0, 1.0)):
        out = torch.empty((1,) + resample.isotropic_shape(vol.shape, voxel_size))
        resample_cuda.isotropic_resample_batch(batch, out, voxel_size)
        assert _bits_equal(out[0], resample.isotropic_resample(batch[0], voxel_size)[0]), voxel_size


def test_the_oasis_grid_is_planned_resampled():
    assert resample.isotropic_shape(OASIS, OASIS_MM) == (160, 256, 256)
    grid = extract.extraction_shape(OASIS, "isotropic", OASIS_MM)
    assert grid == (160, 256, 256)
    # cubic voxels are not resampled (featExtract.cpp:118-204)
    assert extract.extraction_shape(OASIS, "isotropic", (1.2, 1.2, 1.2)) == OASIS
    assert extract.volume_bytes(grid) == math.ceil(18.875 * 4 * 160 * 256 * 256)
    assert extract.plan_subbatches(grid, 32, 80e9) == [32]
    with pytest.raises(ValueError, match="voxel size"):
        extract.extraction_shape(OASIS, "isotropic")


def test_the_batch_wrapper_refuses_mismatched_shapes():
    batch = torch.zeros((2, 4, 5, 6))
    for out in (torch.zeros((3, 5, 5, 6)), torch.zeros((2, 5, 5)), torch.zeros((2, 0, 5, 6))):
        with pytest.raises(ValueError):
            resample_cuda.isotropic_resample_batch(batch, out, (1.0, 1.0, 1.25))


# (host [Z, Y, X], voxel size (dx, dy, dz), seed, -w or -ws): two of one
# shape and voxel size (one batch), that shape at another voxel size, another
# shape, and cubic voxels (not resampled) under a rotated sform
SCANS = [
    ((48, 64, 64), (1.0, 1.0, 1.25), 3, "-w"),
    ((48, 64, 64), (1.0, 1.0, 1.25), 5, "-w"),
    ((48, 64, 64), (1.0, 1.0, 1.5), 7, "-ws"),
    ((60, 40, 58), (1.1, 1.6, 1.0), 9, "-w"),
    ((64, 64, 64), (1.2, 1.2, 1.2), 7, "-ws"),
]
# -2- halves the resampled grid: a scan twice the size
HALVED = ((96, 128, 128), (1.0, 1.0, 1.25), 3, "-w")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The SCANS and HALVED as NIfTI files with a rotated, offset qform and
    sform, and each as the Scan its flag reads: [(path, flag, Scan)]."""
    d = tmp_path_factory.mktemp("scans")
    out = []
    for i, (shape, voxel_size, seed, flag) in enumerate(SCANS + [HALVED]):
        path = str(d / f"scan{i}.nii")
        qto, sto = _affine(seed, voxel_size, [-31.5, 20.25, -12.0]), _affine(seed + 1, voxel_size, [10.0, -20.0, 30.0])
        nifti.write(path, synthetic_volume(shape, seed=seed), voxel_size=voxel_size, qto_xyz=qto, sto_xyz=sto)
        vol = nifti.read_volume(path)
        out.append((path, flag, Scan(vol.data, vol.voxel_size, vol.world_matrix(use_sform=flag == "-ws"))))
    return out


def _cli_features(path, flag, tmp_path, monkeypatch, extra=()):
    """The FeatureSet ``featextract <flag>`` writes for path, on the CPU."""
    got = []
    real = tx_cli.keyfile.write_text

    def keep(feats, *a, **k):
        got.append(feats)
        return real(feats, *a, **k)

    monkeypatch.setattr(tx_cli.keyfile, "write_text", keep)
    monkeypatch.chdir(tmp_path)
    assert tx_cli.main([flag, *extra, path, "out.key"], device="cpu") == 0
    return got[0]


def test_a_mixed_batch_equals_featextract_w_one_volume_at_a_time(scans, tmp_path, monkeypatch):
    with TRACER.record():
        many = extract_features_many([s for _, _, s in scans[:-1]], device="cpu", prescale="isotropic")
    # one batch a (shape, voxel size) group; the cubic one is not resampled
    assert [s.name for s in TRACER.spans].count("input") == 4
    assert [s.name for s in TRACER.spans].count("resample") == 3
    assert TRACER.counts["resampled_volumes"] == 4
    grids = [extract.extraction_shape(s.data.shape, "isotropic", s.voxel_size) for _, _, s in scans[:-1]]
    assert grids[0] == (60, 64, 64) and grids[2] == (72, 64, 64) and grids[3] == (60, 64, 63)
    assert TRACER.counts["resampled_bytes"] == 4 * sum(math.prod(g) for g in grids[:4])
    for i, ((path, flag, scan), got) in enumerate(zip(scans, many)):
        (tmp_path / str(i)).mkdir()
        want = _cli_features(path, flag, tmp_path / str(i), monkeypatch)
        assert len(want) > 0 and _same(got, want), (i, flag)
    # the batch of one and the placement give the same rows
    assert _same(extract_features(scans[3][2], device="cpu", prescale="isotropic"), many[3])
    placed = extract_features_batch([s for _, _, s in scans[:-1]], ["cpu", "cpu"], prescale="isotropic")
    assert all(_same(p, m) for p, m in zip(placed, many))


def test_the_world_mapping_is_the_column_rescaled_matrix(scans):
    _, _, scan = scans[0]
    m = scan.grid_world()
    np.testing.assert_array_equal(m[:3, :3], scan.world[:3, :3] * np.array([1.0, 1.0, 1.0 / 1.25])[None, :])
    np.testing.assert_array_equal(m[:3, 3], scan.world[:3, 3])
    # an Analyze header's matrix, diag(voxel size): the resampled grid's
    # voxels are its millimetres
    analyze = Scan(scan.data, OASIS_MM, np.diag([*OASIS_MM, 1.0]))
    np.testing.assert_array_equal(analyze.grid_world(), np.eye(4))


@pytest.mark.parametrize("flags", [["-2+"], ["-2-"], ["--spatial=2", "--spatial-octaves=1"]])
def test_w_with_another_resolution_flag_resamples_first(flags, scans, tmp_path, monkeypatch):
    """-w -2+, -w -2- and -w --spatial: the scan resampled by the pipeline's
    isotropic route, then doubled, halved or sharded, then mapped to world
    millimetres; the CLI's rows equal that sequence's."""
    path, _, scan = scans[-1 if flags == ["-2-"] else 0]
    got = _cli_features(path, "-w", tmp_path, monkeypatch, extra=flags)
    data = extract.prescaled_volume(scan, "isotropic", "cpu")
    if flags[0] == "-2+":
        feats = extract_features(data, device="cpu", prescale="double")
    elif flags[0] == "-2-":
        feats = extract_features(resample.subsample_2x(data), device="cpu")
        feats.xyz *= 2.0
        feats.scale *= 2.0
    else:
        feats = extract_features_spatial(data, ["cpu", "cpu"], sharded_octaves=1)
    assert len(got) > 0 and _same(got, extract.in_world_mm(feats, scan))


def test_featextract_w_time_prints_the_resample_span_and_counters(scans, tmp_path, monkeypatch, capsys):
    path, _, _ = scans[0]
    monkeypatch.chdir(tmp_path)
    assert tx_cli.main(["-w", "--time", path, "out.key"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "resample " in out and "input " in out
    counts = dict(line.split() for line in out.splitlines() if line.startswith("resampled_"))
    assert counts == {"resampled_volumes": "1", "resampled_bytes": str(4 * 60 * 64 * 64)}


def test_routes_without_the_isotropic_mode_raise(scans):
    _, _, scan = scans[0]
    with pytest.raises(ValueError, match="Z-sharded path takes no prescale 'isotropic'"):
        extract_features_spatial(scan, ["cpu", "cpu"], prescale="isotropic", sharded_octaves=1)
    # a Scan needs the isotropic mode, and the isotropic mode Scans
    with pytest.raises(ValueError, match="takes Scans"):
        extract_features(scan, device="cpu")
    with pytest.raises(ValueError, match="takes Scans"):
        extract_features_many([scan.data], device="cpu", prescale="isotropic")
    with pytest.raises(ValueError, match="takes Scans"):
        extract_features_many([scan, scan.data], device="cpu", prescale="double")
    with pytest.raises(ValueError, match="'isotropic'"):
        extract_features_many([scan], device="cpu", prescale="anisotropic")
    with pytest.raises(ValueError, match="pre_blurred"):
        extract_features_many([scan], device="cpu", prescale="isotropic", pre_blurred=True)


def test_a_scan_is_immutable_and_keeps_its_matrix(scans):
    _, _, scan = scans[1]
    with pytest.raises(dataclasses.FrozenInstanceError):
        scan.voxel_size = (1.0, 1.0, 1.0)
    before = scan.world.copy()
    scan.grid_world()[:] = 0
    np.testing.assert_array_equal(scan.world, before)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _chain_on(batch: torch.Tensor, voxel_size) -> torch.Tensor:
    return torch.stack([resample.isotropic_resample(v, voxel_size)[0] for v in batch])


@pytest.mark.cuda
@pytest.mark.parametrize("shape, voxel_size", [
    ((32,) + OASIS, OASIS_MM),
    ((1, 5, 7, 9), (1.0, 1.0, 1.25)), ((2, 6, 8, 10), (1.2, 0.9375, 1.0)), ((1, 1, 7, 9), (1.0, 1.0, 1.5)),
    ((1, 5, 1, 9), (1.0, 3.0, 1.0)), ((1, 5, 7, 1), (3.0, 1.0, 1.0)), ((1, 1, 1, 1), (1.0, 1.0, 1.25)),
    ((3, 37, 75, 61), (0.9375, 0.9375, 1.2)), ((2, 91, 109, 91), (1.5, 1.0, 1.0)),
])
def test_the_resample_kernel_equals_the_plain_chain_on_the_card(card, shape, voxel_size):
    rng = np.random.default_rng(sum(shape))
    batch = torch.from_numpy((100 * rng.standard_normal(shape)).astype(np.float32)).to(card)
    out = torch.full((shape[0],) + resample.isotropic_shape(shape[1:], voxel_size), float("nan"), device=card)
    before = launches("sift3d_isotropic_resample")
    resample_cuda.isotropic_resample_batch(batch, out, voxel_size)
    torch.cuda.synchronize()
    assert launches("sift3d_isotropic_resample") == before + 1
    assert _bits_equal(out, _chain_on(batch, voxel_size))
    if shape[0] <= 3:  # and the CPU's chain
        assert _bits_equal(out.cpu(), _chain_on(batch.cpu(), voxel_size))


@pytest.mark.cuda
def test_a_native_cohort_on_the_card_equals_the_cpu(card):
    vols = [synthetic_volume((48, 64, 64), seed=s) for s in (3, 5)]
    scans = [Scan(v, (1.0, 1.0, 1.25), np.diag([1.0, 1.0, 1.25, 1.0])) for v in vols]
    before = launches("sift3d_isotropic_resample")
    got = extract_features_many(scans, device=card, prescale="isotropic")
    assert launches("sift3d_isotropic_resample") == before + 1
    want = extract_features_many(scans, device="cpu", prescale="isotropic")
    assert all(len(w) > 0 and _same(g, w) for g, w in zip(got, want))


def _event_ms(fn, calls: int) -> float:
    """Device ms of `calls` back-to-back calls of fn, between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@pytest.mark.cuda
def test_the_resample_kernel_on_an_oasis_cohort_prints_its_times(card):
    """The kernel on a [32, 128, 256, 256] batch at 1 x 1 x 1.25 mm: its ms
    (median of 10 calls, each between CUDA events), back to back (a burst
    of 20), its share of the bytes bound (4 B a voxel read, 4 written, at
    3.35 TB/s) and the plain chain's ms on the card (volume by volume,
    stacked); printed as one line, and the two bit-equal."""
    gen = torch.Generator(device=card).manual_seed(25)
    batch = 100 * torch.randn((32,) + OASIS, generator=gen, device=card)
    out = torch.empty((32,) + resample.isotropic_shape(OASIS, OASIS_MM), device=card)

    def kernel():
        resample_cuda.isotropic_resample_batch(batch, out, OASIS_MM)

    for _ in range(3):
        kernel()
    one = sorted(_event_ms(kernel, 1) for _ in range(10))[5]
    b2b = _event_ms(kernel, 20) / 20
    plain = _event_ms(lambda: _chain_on(batch, OASIS_MM), 1)
    bound = 4 * (batch.numel() + out.numel()) / 3.35e12 * 1e3
    print(f"isotropic_resample [32, 128, 256, 256] -> {list(out.shape)}: kernel {one:.4f} ms ({b2b:.4f} b2b), "
          f"bound {bound:.4f} ms (bytes), {100 * bound / one:.2f}% of it, plain chain {plain:.3f} ms; "
          f"{torch.cuda.get_device_name(card)}")
    assert _bits_equal(out, _chain_on(batch, OASIS_MM))
