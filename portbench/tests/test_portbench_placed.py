"""The node cell (``t1_cohort_4card``: ``extract_features_batch`` over
four cards) on the CPU, every card "cpu", at a test size: a sound run, a
traced run that reads the cell's per-layer metrics, the sample of each
card's first and last volume, the ``place_tail_ms`` reader, the control,
faults of the placement planted in the timed path, each of which must
turn ``correct`` false, and the cell's entries in ``BENCHMARK.json``."""

import json

import pytest

import run
from conftest import BENCH, ROOT

CELL = "t1_cohort_4card"
SEED = 2**31 + 77
CARDS = ["cpu"] * 4
SMALL = {"grid_zyx": [64, 72, 64]}
# eight volumes a call over four cards: groups [0, 4], [1, 5], [2, 6], [3, 7], all sampled
PARAMS = {"batch": 8, "distinct": 8, "blobs": 120, "check_volumes": 8}


def small_run(control=False, trace=False):
    params = dict(PARAMS, trace_calls=1) if trace else PARAMS
    return run.run(CELL, SEED, 0.3, trace, CARDS, say=lambda s: None, config_override=SMALL,
                   params_override=params, control=control)


def test_sound_run_is_correct_and_prints_the_contract():
    res = small_run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 8
    assert sorted(res["metrics"]) == ["setup_s", "volumes_per_s"]
    assert res["device"]["count"] == 4
    assert res["checks"]["feature_rows_off_share"]["value"] <= res["checks"]["feature_rows_off_share"]["limit"]


def test_a_traced_run_reads_the_cells_per_layer_metrics():
    res = small_run(trace=True)
    assert res["correct"] is True
    metrics = res["metrics"]
    assert metrics["place_tail_ms.node4"]["value"] > 0
    assert 0 <= metrics["idle_share.node4"]["value"] <= 1 and 0 <= metrics["unranged_idle.node4"]["value"] <= 1
    assert "peak_mem_gb.node4" not in metrics  # no device memory on the CPU


def test_the_control_is_not_correct():
    assert small_run(control=True)["correct"] is False


def test_the_sample_holds_each_cards_first_and_last_volume():
    cell = run.load_cell(CELL, {"grid_zyx": [8, 8, 8]})
    mix = run.load_module("mixes", cell.spec["mix"])
    assert mix.groups(list(range(10)), 4) == [[0, 4, 8], [1, 5, 9], [2, 6], [3, 7]]
    state = mix.setup(cell.config, cell.spec["params"], SEED, CARDS, lambda s: None)
    # the cell's own call: 128 volumes, 32 a card, each card's first and last
    assert state["sample"] == [0, 1, 2, 3, 124, 125, 126, 127]
    assert len(state["vols"]) == 128


def test_place_tail_ms_reads_the_programs_span_per_call():
    from devtrace import Trace

    from test_portbench_program_spans import ctx_of, reader

    ranges = {"stage:place": [(0.0, 1e6), (1.2e6, 2e6)], "stage:place_tail": [(0.7e6, 1e6), (1.9e6, 2e6)]}
    trace = Trace((0.0, 2e6), {d: [] for d in range(4)}, [], 0, ranges)
    assert reader("place_tail_ms")(ctx_of(trace, units=256, calls=2, devices=range(4))) == pytest.approx(200.0)
    # the parent program opens no such span: no value, and no exception
    assert reader("place_tail_ms")(ctx_of(Trace((0.0, 1e6), {0: []}, [], 0, {}))) is None
    assert reader("place_tail_ms")(ctx_of(None)) is None


def _faulty(monkeypatch, fault):
    """The mix's placement with `fault` applied to its answers in the
    window, after the warm call (in the volumes' input order; card c's
    volumes are c, c + 4, ...)."""
    import sift3d_torch

    real = sift3d_torch.extract_features_batch
    calls = []

    def placed(vols, mesh, *a, **k):
        calls.append(len(vols))
        out = list(real(vols, mesh, *a, **k))
        return out if len(calls) == 1 else fault(out)

    monkeypatch.setattr(sift3d_torch, "extract_features_batch", placed)


def _card_left_out(out):
    out[3::4] = [None] * len(out[3::4])  # card 3's group came back without results
    return out


def _swapped_across_cards(out):
    out[0], out[1] = out[1], out[0]  # volume 0 (card 0) and volume 1 (card 1)
    return out


def _one_cards_results_for_another(out):
    out[1::4] = out[0::4]  # card 0's results for card 1's volumes
    return out


@pytest.mark.parametrize("fault", [_card_left_out, _swapped_across_cards, _one_cards_results_for_another])
def test_a_fault_of_the_placement_is_caught(monkeypatch, fault):
    _faulty(monkeypatch, fault)
    res = small_run()
    assert res["correct"] is False and res["failed"] >= 2


def test_the_cells_entries_hold_the_contract_with_four_chips():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())
    assert entry["chips"] == spec["chips"] == config["chips"] == 4
    assert spec["params"]["batch"] == 32 * entry["chips"] and config["reduced"] == []
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    e2e = [m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert sorted(e2e) == ["setup_s", "volumes_per_s"]
    per_layer = [m for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])]
    assert per_layer and all(m["moves"] == "volumes_per_s" for m in per_layer)
    # no reader of a span that only the placement's worker threads open
    assert not any(m["name"].split(".")[0] in ("input_ms", "emit_ms", "pyramid_ms") for m in per_layer)
