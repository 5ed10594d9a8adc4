"""The -2+ cohort cell (``t1x2_cohort_b32``) on the CPU at a test size:
its reference's doubling against the port's plain ``double_size`` bit for
bit, its reference against the port's CPU path within the extraction
limits, a sound run, a traced run that reads the cell's span metrics, the
control, and faults planted in the timed path, each of which must turn
``correct`` false."""

import dataclasses

import numpy as np
import pytest
import torch

import compare
import run
from reference import prescaled
from traffic.volumes import blob_texture

CELL = "t1x2_cohort_b32"
SEED = 2**31 + 77
# a 48x52x48 grid, doubled to 96x104x96
SMALL = {"grid_zyx": [48, 52, 48], "extraction_grid_zyx": [96, 104, 96]}
PARAMS = {"batch": 4, "distinct": 4, "blobs": 80, "check_volumes": 4}


def small_run(control=False):
    return run.run(CELL, SEED, 0.3, False, ["cpu"], say=lambda s: None, config_override=SMALL,
                   params_override=PARAMS, control=control)


@pytest.fixture
def two_subbatches(monkeypatch):
    """The program's planner given room for two of the four volumes, in the
    warm call and every call after it."""
    from sift3d_torch.pipeline import extract

    per = extract.volume_bytes(SMALL["extraction_grid_zyx"])
    monkeypatch.setattr(extract, "device_budget", lambda dev: 2 * per)
    return extract


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 6, 8), (1, 6, 7), (5, 1, 7), (5, 6, 1), (1, 1, 1)])
def test_the_references_doubling_equals_the_ports_plain_chain(shape):
    from sift3d_torch.kernels.resample import double_size

    vol = (100 * np.random.default_rng(sum(shape)).standard_normal(shape)).astype(np.float32)
    want = double_size(torch.from_numpy(vol)).numpy()
    got = prescaled.double_size(vol)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_the_reference_agrees_with_the_ports_cpu_path():
    from sift3d_torch.pipeline.extract import extract_features

    vol = blob_texture(SMALL["grid_zyx"], 11, 80, "cpu").numpy()
    want = prescaled.features(vol, {}, "goh")
    got = compare.fields(extract_features(vol, device="cpu", prescale="double"))
    assert len(want["xyz"]) > 10
    assert compare.share(*compare.feature_rows_off(got, want)) <= compare.LIMITS["extraction"]["feature_rows_off_share"]


def test_sound_run_is_correct_and_prints_the_contract():
    res = small_run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert sorted(res["metrics"]) == ["setup_s", "volumes_per_s"]


def test_volumes_per_subbatch_counts_the_input_spans():
    from devtrace import Trace

    from test_portbench_program_spans import ctx_of, reader

    trace = Trace((0.0, 2e6), {0: []}, [], 0, {"stage:input": [(0.0, 1e5), (1e6, 1.1e6), (1.5e6, 1.6e6)]})
    assert reader("volumes_per_subbatch")(ctx_of(trace, units=96, calls=3)) == pytest.approx(32.0)
    # the parent program's trace holds no span of its own
    assert reader("volumes_per_subbatch")(ctx_of(Trace((0.0, 1e6), {0: []}, [], 0, {}))) is None
    assert reader("volumes_per_subbatch")(ctx_of(None)) is None


def test_a_traced_run_reads_the_cells_span_metrics(two_subbatches):
    res = run.run(CELL, SEED, 0.3, True, ["cpu"], say=lambda s: None, config_override=SMALL,
                  params_override=dict(PARAMS, trace_calls=1))
    assert res["correct"] is True
    metrics = res["metrics"]
    # room for two of four volumes: two sub-batches a call
    assert metrics["volumes_per_subbatch.x2"]["value"] == pytest.approx(2.0)
    assert all(metrics[n]["value"] > 0 for n in ("input_ms.x2", "upsample_ms.x2", "emit_ms.x2"))
    assert 0 <= metrics["unranged_idle.x2"]["value"] <= 1


def test_the_control_is_not_correct():
    res = small_run(control=True)
    assert res["correct"] is False


def test_the_sample_holds_each_subbatchs_first_and_last_volume(two_subbatches):
    from spans import OFF

    # six volumes with room for two: sub-batches [0, 1], [2, 3], [4, 5]
    cell = run.load_cell(CELL, SMALL, dict(PARAMS, batch=6, distinct=6, check_volumes=3))
    mix = run.load_module("mixes", cell.spec["mix"])
    state = mix.setup(cell.config, cell.spec["params"], SEED, ["cpu"], lambda s: None)
    mix.warmup(state, OFF)
    assert state["sample"] == [0, 1, 2, 3, 4, 5] and state["outputs"] == {i: [] for i in range(6)}


def test_geometry_left_in_the_doubled_grid_is_caught(monkeypatch):
    import sift3d_torch

    real = sift3d_torch.extract_features_many

    def doubled_back(*a, **k):
        return [dataclasses.replace(f, xyz=f.xyz * 2, scale=f.scale * 2) for f in real(*a, **k)]

    monkeypatch.setattr(sift3d_torch, "extract_features_many", doubled_back)
    assert small_run()["correct"] is False


def test_a_subbatchs_volume_left_out_is_caught(two_subbatches, monkeypatch):
    real = two_subbatches._subbatch
    seen = []

    def last_left_out(imgs, shape, dev, cfg, timer, scale, descriptor, pre_blurred, prescale, parts):
        seen.append(len(imgs))
        if len(seen) % 2 == 0:  # every call's second sub-batch runs without its last volume
            imgs, parts = imgs[:-1], parts[:-1]
        return real(imgs, shape, dev, cfg, timer, scale, descriptor, pre_blurred, prescale, parts)

    monkeypatch.setattr(two_subbatches, "_subbatch", last_left_out)
    assert small_run()["correct"] is False
    assert seen[:2] == [2, 2]


def test_the_doubled_volume_blurred_as_if_at_scale_1_is_caught(monkeypatch):
    from sift3d_torch.pipeline import extract

    monkeypatch.setattr(extract, "_initial_scale", lambda prescale, scale, pre_blurred=False: 1.0)
    assert small_run()["correct"] is False
