"""BENCHMARK.json against the benchmark's contract and its files."""

import json
import re

import pytest

from conftest import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51 and isinstance(BENCHMARK["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCHMARK[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_fields():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(m["layer"])
        if m["unit"] == "%":
            assert m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCHMARK["workloads"]])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = [m["name"] for m in BENCHMARK["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in _cells_of(m) for m in BENCHMARK["per_layer"]), w["name"]


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in _cells_of(m):
            assert cell in _cells_of(e2e[m["moves"]]), (m["name"], cell)


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in BENCHMARK["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCHMARK["workloads"])
    assert len(four) <= max(1, len(BENCHMARK["workloads"]) // 4)


def test_cells_configs_and_files_agree():
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    pairs = set()
    for w in BENCHMARK["workloads"]:
        assert TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert {k: spec[k] for k in ("config", "traffic", "chips")} == {k: w[k] for k in ("config", "traffic", "chips")}
        assert (BENCH / "mixes" / f"{spec['mix']}.py").is_file()
        assert w["config"] in configs
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_every_metric_has_a_reader():
    import run

    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(run.metric_reader(m["name"]).read), m["name"]


def test_perf_md_names_every_layer():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCHMARK["per_layer"]:
        assert m["layer"] in perf, m["layer"]
