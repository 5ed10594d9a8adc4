"""The -w cohort cell (``oasis1_w_cohort_b32``) on the CPU at a test size:
its configuration and cell, its generator, its reference's resample
against the port's plain chain bit for bit, its reference against the
port's CPU path within the extraction limits, a sound run, a traced run
that reads the cell's metrics, the readers on hand-built traces, the
control, and faults planted in the timed path, each of which must turn
``correct`` false."""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import compare
import roofline
import roofline_isotropic
import run
from reference import isotropic
from traffic.native import native_texture, native_volumes

from test_portbench_program_spans import ctx_of, reader

CELL = "oasis1_w_cohort_b32"
SEED = 2**31 + 91
# a 40x48x48 scan at 1 x 1 x 1.25 mm, resampled to 50x48x48
SMALL = {"grid_zyx": [40, 48, 48], "extraction_grid_zyx": [50, 48, 48]}
PARAMS = {"batch": 4, "distinct": 4, "blobs": 80, "check_volumes": 4}
# a header with an origin, as a NIfTI conversion writes one: the rows' grid
# voxels and their millimetres then differ
CENTRED = [[1.0, 0.0, 0.0, -24.0], [0.0, 1.0, 0.0, -24.0], [0.0, 0.0, 1.25, -25.0], [0.0, 0.0, 0.0, 1.0]]


def small_run(control=False, config=None, trace=False):
    return run.run(CELL, SEED, 0.3, trace, ["cpu"], say=lambda s: None, config_override=dict(SMALL, **(config or {})),
                   params_override=dict(PARAMS, trace_calls=1) if trace else PARAMS, control=control)


def test_the_configuration_and_the_cell_load():
    cell = run.load_cell(CELL)
    conf = cell.config
    assert (cell.entry["chips"], cell.spec["mix"], cell.spec["traffic"]) == (1, "cohort_native", "host_cohort_b32_w")
    assert conf["grid_zyx"] == [128, 256, 256] and conf["voxel_size_xyz_mm"] == [1.0, 1.0, 1.25]
    assert conf["prescale"] == "isotropic" and conf["reduced"] == []
    assert list(isotropic.grid_shape(conf["grid_zyx"], conf["voxel_size_xyz_mm"])) == conf["extraction_grid_zyx"]
    np.testing.assert_array_equal(conf["world_matrix"], np.diag([1.0, 1.0, 1.25, 1.0]))
    assert [m["name"] for m in cell.end_to_end] == ["volumes_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {f"{n}.native" for n in ("resample_ms", "resample_roofline", "prescaled_pyramid_roofline",
                                             "pyramid_ms", "input_ms", "emit_ms", "idle_share", "unranged_idle",
                                             "peak_mem_gb", "launches_per_volume")}


def test_the_texture_is_drawn_in_millimetres():
    """A scan of 1.25 mm slices is the 1 mm texture sampled at every
    1.25 mm along z: the same blobs, 1.25x shorter in voxels."""
    fine = native_texture((60, 16, 12), (1.0, 1.0, 1.0), 5, 20, "cpu")
    coarse = native_texture((48, 16, 12), (1.0, 1.0, 1.25), 5, 20, "cpu")
    # the extents differ (60 mm, 60 mm), the blobs' draws are alike: planes at 0, 5, 10, ... mm coincide
    torch.testing.assert_close(coarse[::4], fine[::5], rtol=1e-4, atol=1e-3)
    a, b = native_volumes((8, 9, 10), (1.0, 1.0, 1.25), SEED, 2, 10, "cpu")
    assert a.dtype == np.float32 and a.shape == (8, 9, 10) and not np.array_equal(a, b)
    assert np.array_equal(native_volumes((8, 9, 10), (1.0, 1.0, 1.25), SEED, 1, 10, "cpu")[0], a)


@pytest.mark.parametrize("voxel_size", [(1.0, 1.0, 1.25), (1.0, 1.5, 1.0), (3.0, 1.0, 1.0), (0.9375, 0.9375, 1.2)])
@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 6, 8), (1, 6, 7), (5, 1, 7), (5, 6, 1)])
def test_the_references_resample_equals_the_ports_plain_chain(shape, voxel_size):
    from sift3d_torch.kernels.resample import isotropic_resample

    vol = (100 * np.random.default_rng(sum(shape)).standard_normal(shape)).astype(np.float32)
    want, _ = isotropic_resample(torch.from_numpy(vol), voxel_size)
    got = isotropic.resample(vol, voxel_size)
    assert got.dtype == np.float32 and got.shape == tuple(want.shape) == isotropic.grid_shape(shape, voxel_size)
    assert np.array_equal(got, want.numpy())


def test_the_references_world_mapping_equals_the_ports():
    from sift3d_torch.core.featureset import FeatureSet
    from sift3d_torch.pipeline.extract import Scan, in_world_mm

    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    world = np.eye(4)
    world[:3, :3] = q * np.array([1.0, 1.0, 1.25])
    world[:3, 3] = [-90.0, 12.5, -70.25]
    ori, _ = np.linalg.qr(rng.standard_normal((30, 3, 3)))
    rows = dict(xyz=rng.uniform(0, 64, (30, 3)).astype(np.float32), scale=rng.uniform(1, 9, 30).astype(np.float32),
                ori=ori.astype(np.float32), eigs=np.ones((30, 3), np.float32), info=np.zeros(30, np.uint32),
                desc=np.zeros((30, 64), np.float32))
    want = in_world_mm(FeatureSet(**rows), Scan(None, (1.0, 1.0, 1.25), world))
    got = isotropic.to_world(rows, isotropic.grid_world((1.0, 1.0, 1.25), world))
    for k in ("xyz", "scale", "ori"):
        np.testing.assert_allclose(got[k], getattr(want, k), rtol=1e-6, atol=1e-5)


def test_the_reference_agrees_with_the_ports_cpu_path():
    from sift3d_torch.pipeline.extract import Scan, extract_features

    vol = native_texture(SMALL["grid_zyx"], (1.0, 1.0, 1.25), 11, 80, "cpu").numpy()
    want = isotropic.features(vol, (1.0, 1.0, 1.25), CENTRED, {}, "goh")
    got = compare.fields(extract_features(Scan(vol, (1.0, 1.0, 1.25), np.array(CENTRED)), device="cpu",
                                          prescale="isotropic"))
    assert len(want["xyz"]) > 10
    assert compare.share(*compare.feature_rows_off(got, want)) <= compare.LIMITS["extraction"]["feature_rows_off_share"]


def test_sound_run_is_correct_and_prints_the_contract():
    res = small_run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert sorted(res["metrics"]) == ["setup_s", "volumes_per_s"]


def test_a_traced_run_reads_the_cells_span_metrics():
    res = small_run(trace=True)
    assert res["correct"] is True
    metrics = res["metrics"]
    assert all(metrics[n]["value"] > 0 for n in ("resample_ms.native", "input_ms.native", "pyramid_ms.native",
                                                 "emit_ms.native"))
    assert 0 <= metrics["unranged_idle.native"]["value"] <= 1
    # no device on the CPU: no roofline, no peak
    assert not {"resample_roofline.native", "prescaled_pyramid_roofline.native", "peak_mem_gb.native"} & set(metrics)


def test_the_resample_readers_read_the_span_and_nothing_without_it():
    from devtrace import Trace, union

    # 0.2 s of the span over 4 volumes, 0.1 s of it busy on the device
    trace = Trace((0.0, 1e6), {0: union([(1e5, 2e5)])}, [], 0, {"stage:resample": [(0.0, 1e5), (1e5, 2e5)]})
    ctx = ctx_of(trace, units=4)
    ctx.config = {"grid_zyx": [128, 256, 256], "extraction_grid_zyx": [160, 256, 256]}
    ctx.roofline = roofline
    assert reader("resample_ms")(ctx) == pytest.approx(200.0 / 4)
    least_s = 4 * 4 * (128 + 160) * 256 * 256 / 3.35e12
    assert reader("resample_roofline")(ctx) == pytest.approx(100.0 * least_s / 0.1)
    # the parent commit's program opens no resample span
    parent = types.SimpleNamespace(**dict(vars(ctx), trace=Trace((0.0, 1e6), {0: []}, [], 0, {})))
    assert reader("resample_ms")(parent) is None and reader("resample_roofline")(parent) is None
    assert reader("resample_ms")(ctx_of(None)) is None


def test_the_resample_bytes_by_hand():
    # OASIS-1: 8,388,608 voxels in, 10,485,760 out, 4 bytes each, a volume
    assert roofline_isotropic.resample_bytes([128, 256, 256], [160, 256, 256], 1) == 4 * (8388608 + 10485760)
    ms, by = roofline.bound(roofline_isotropic.resample_bytes([128, 256, 256], [160, 256, 256], 32), 0.0)
    assert by == "bytes" and ms == pytest.approx(32 * 75497472 / 3.35e9)
    assert math.isclose(ms, 0.7212, rel_tol=1e-3)


def test_the_control_is_not_correct():
    assert small_run(control=True)["correct"] is False


def test_a_nearest_neighbour_resample_is_caught(monkeypatch):
    from sift3d_torch.pipeline import extract

    def nearest(batch, out, voxel_size):
        dx, dy, dz = voxel_size
        dmin = min(voxel_size)
        idx = [torch.clamp((torch.arange(n) * (dmin / d)).round().long(), max=m - 1)
               for n, d, m in zip(out.shape[1:], (dz, dy, dx), batch.shape[1:])]
        out.copy_(batch[:, idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]])
        return out

    monkeypatch.setattr(extract, "isotropic_resample_batch", nearest)
    assert small_run()["correct"] is False


def test_z_spacing_read_as_1_2_mm_is_caught(monkeypatch):
    import sift3d_torch

    real = sift3d_torch.extract_features_many

    def misread(scans, *a, **k):
        return real([dataclasses.replace(s, voxel_size=(1.0, 1.0, 1.2)) for s in scans], *a, **k)

    monkeypatch.setattr(sift3d_torch, "extract_features_many", misread)
    assert small_run()["correct"] is False


def test_rows_left_in_the_grids_voxels_are_caught(monkeypatch):
    """Rows in the resampled grid's voxels, not world mm: caught under a
    header with an origin. Under the cell's own Analyze matrix, diag(1, 1,
    1.25), the 1 mm grid's voxels are its millimetres: the fault writes the
    same rows, and no comparison can see it."""
    from sift3d_torch.pipeline import extract

    monkeypatch.setattr(extract, "in_world_mm", lambda fs, scan: fs)
    assert small_run(config={"world_matrix": CENTRED})["correct"] is False
    assert small_run()["correct"] is True
