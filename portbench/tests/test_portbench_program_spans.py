"""The readers of the program's own spans (``sift3d_torch.utils.timing``)
and of the idle time no range names, on hand-built traces, and a traced
run of each cell on the CPU, where the program's spans reach the trace."""

import importlib.util
import types

import pytest

from conftest import BENCH
from devtrace import Trace, union

OUTSIDE = "host outside the harness's ranges"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx_of(trace, units=1, calls=1, devices=(0,)):
    return types.SimpleNamespace(trace=trace, units=units, calls=calls, devices=list(devices))


def test_span_readers_sum_their_ranges_per_unit():
    ranges = {"stage:input": [(0.0, 3e5), (1e6, 1.1e6)], "stage:emit": [(5e5, 6e5), (5.5e5, 7e5)],
              "stage:hough_hypotheses": [(2e5, 4e5)], "stage:refine": [(7e5, 7.5e5), (8e5, 8.5e5)]}
    trace = Trace((0.0, 2e6), {0: []}, [], 0, ranges)
    ctx = ctx_of(trace, units=4, calls=2)
    assert reader("input_ms")(ctx) == pytest.approx(400.0 / 4)  # 0.3 s + 0.1 s over 4 volumes
    assert reader("emit_ms")(ctx) == pytest.approx(200.0 / 4)  # overlapping ranges count once
    assert reader("hypotheses_ms")(ctx) == pytest.approx(200.0 / 2)
    assert reader("refine_ms")(ctx) == pytest.approx(100.0 / 2)


@pytest.mark.parametrize("name", ["input_ms", "emit_ms", "hypotheses_ms", "refine_ms"])
def test_span_readers_read_nothing_where_the_program_has_no_such_span(name):
    """The parent commit's program opens none of these spans: no value,
    and no exception."""
    harness_only = Trace((0.0, 1e6), {0: [(0.0, 1e5)]}, [], 3, {"stage:canonical": [(0.0, 5e5)],
                                                                  "span:hough": [(5e5, 9e5)]})
    assert reader(name)(ctx_of(harness_only)) is None
    assert reader(name)(ctx_of(None)) is None


def test_unranged_idle_counts_only_gaps_outside_every_range():
    # window 0..10 s; busy [1, 2], [4, 5], [8, 9]: gaps [0, 1], [2, 4], [5, 8], [9, 10]
    busy = {0: union([(1e6, 2e6), (4e6, 5e6), (8e6, 9e6)])}
    ranges = {
        "span:hough": [(1.5e6, 3.5e6)],  # holds the midpoint 3 s of gap [2, 4]
        "stage:refine": [(2.5e6, 3.2e6)],  # nested: still ranged
        "stage:emit": [(5.0e6, 6.4e6)],  # ends before gap [5, 8]'s midpoint 6.5 s: that gap is unranged
        "stage:input": [(9.4e6, 9.6e6)],  # holds gap [9, 10]'s midpoint 9.5 s, covers only a fifth of it
    }
    trace = Trace((0.0, 10e6), busy, [], 0, ranges)
    # unranged: [0, 1] (1 s) and [5, 8] (3 s) of the 10 s window
    assert reader("unranged_idle")(ctx_of(trace)) == pytest.approx(0.4)
    outside = dict(trace.breakdown([0], top=100)["idle_gaps"])[OUTSIDE]
    assert reader("unranged_idle")(ctx_of(trace)) == pytest.approx(outside / trace.window_s)
    # one more range over 6.5 s names the last unranged gap but for [0, 1]
    ranges["stage:emit"].append((6.4e6, 6.6e6))
    assert reader("unranged_idle")(ctx_of(trace)) == pytest.approx(0.1)


def test_unranged_idle_averages_over_cards_and_matches_the_breakdown_on_a_busy_trace():
    import random

    rnd = random.Random(5)
    busy, ranges = {}, {}
    for d in (0, 1):
        ivs = []
        t = 0.0
        while t < 5e6:
            s = t + rnd.uniform(10, 5e4)
            ivs.append((s, s + rnd.uniform(5, 2e4)))
            t = ivs[-1][1]
        busy[d] = union(ivs)
    for k in range(200):
        s = rnd.uniform(0, 5e6)
        ranges.setdefault(f"stage:s{k % 7}", []).append((s, s + rnd.uniform(1e3, 6e4)))
    trace = Trace((0.0, 5e6), {d: [iv for iv in ivs if iv[1] <= 5e6] for d, ivs in busy.items()}, [], 0, ranges)
    outside = dict(trace.breakdown([0, 1], top=100)["idle_gaps"]).get(OUTSIDE, 0.0)
    got = reader("unranged_idle")(ctx_of(trace, devices=(0, 1)))
    assert 0 < got < 1
    assert got == pytest.approx(outside / 2 / trace.window_s)


def test_unranged_idle_without_a_range_is_the_idle_share():
    trace = Trace((0.0, 2e6), {0: [(0.0, 5e5)]}, [], 0, {})
    assert reader("unranged_idle")(ctx_of(trace)) == pytest.approx(0.75)
    assert reader("unranged_idle")(ctx_of(None)) is None


NEW = {"t1_cohort_b32": ["input_ms.cohort", "emit_ms.cohort", "unranged_idle.cohort"],
       "t1_single": ["input_ms.single", "emit_ms.single", "unranged_idle.single"],
       "t1_groupmatch32": ["hypotheses_ms.match", "refine_ms.match", "unranged_idle.match"]}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_cpu_run_reads_the_programs_spans(cell):
    """The program's spans reach the harness's trace through the profiler
    (the extraction cells' through the harness's timer, the match cell's
    through the process's tracer), and each new metric reads a value."""
    import run

    match = cell == "t1_groupmatch32"
    params = ({"count": 4, "rows": 120, "trace_calls": 1} if match else
              {"batch": 2, "distinct": 2, "blobs": 80, "check_volumes": 1, "warmup_volumes": 1, "trace_calls": 1})
    res = run.run(cell, 2**31 + 77, 0.1, True, ["cpu"], say=lambda s: None,
                  config_override=None if match else {"grid_zyx": [48, 52, 48]}, params_override=params)
    assert res["correct"] is True
    for name in NEW[cell]:
        assert name in res["metrics"], name
    assert all(res["metrics"][n]["value"] > 0 for n in NEW[cell][:2])
    assert 0 <= res["metrics"][NEW[cell][2]]["value"] <= 1
