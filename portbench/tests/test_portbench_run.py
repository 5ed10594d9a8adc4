"""Whole runs of the harness on the CPU at a test size: what it refuses,
the control it holds the program against, and faults planted in the
timed path underneath, each of which must turn ``correct`` false. The
look for a card is skipped by calling ``run.run`` on CPU devices."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

import run
from conftest import BENCH, ROOT

SMALL = {"grid_zyx": [64, 72, 64]}
EXTRACT = {"batch": 2, "distinct": 2, "blobs": 120, "check_volumes": 2, "warmup_volumes": 1}
MATCH = {"count": 4, "rows": 120}
SEED = 2**31 + 77
# the cells' own batches and samples, on a grid small enough for the CPU
TINY = {"grid_zyx": [48, 52, 48]}
OWN = {"blobs": 80}


def small_run(cell, devices=("cpu",), control=False, config=None, params=None):
    match = cell == "t1_groupmatch32"
    return run.run(cell, SEED, 0.3, False, list(devices), say=lambda s: None,
                   config_override=config or (None if match else SMALL),
                   params_override=params or (MATCH if match else EXTRACT), control=control)


def test_without_a_card_no_result_and_a_nonzero_exit():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "t1_cohort_b32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0
    assert "metrics" not in p.stdout and "correct" not in p.stdout


def test_without_the_program_no_result_and_a_nonzero_exit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            f"print(run.run('t1_cohort_b32', 1, 0.1, False, ['cpu'], config_override={SMALL!r}, "
            f"params_override={EXTRACT!r}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0 and "sift3d_torch" in p.stderr
    assert "correct" not in p.stdout


@pytest.mark.parametrize("cell", ["t1_cohort_b32", "t1_single", "t1_groupmatch32"])
def test_sound_run_is_correct_and_prints_the_contract(cell):
    res = small_run(cell)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", ["t1_cohort_b32", "t1_groupmatch32"])
def test_the_control_is_not_correct(cell):
    res = small_run(cell, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _altered(fs):
    """A FeatureSet whose every row lies one scale off in x: an answer
    altered where it is produced."""
    xyz = fs.xyz.copy()
    xyz[:, 0] += fs.scale
    return dataclasses.replace(fs, xyz=xyz)


def test_the_sample_holds_every_card_and_both_halves_of_every_batch():
    import extraction

    cohort = extraction.sample(SEED, 4, list(range(32)), [list(range(32))])
    assert len(cohort) == 4 and {0, 31} <= set(cohort)
    assert any(i < 16 for i in cohort[1:-1]) and any(i >= 16 for i in cohort[1:-1])
    cards = [[c + 4 * k for k in range(32)] for c in range(4)]
    placed = extraction.sample(SEED, 8, list(range(128)), cards)
    assert sorted(placed) == sorted([g[0] for g in cards] + [g[-1] for g in cards])
    assert extraction.sample(SEED, 4, [5, 3, 9, 1, 0], None) == [1, 3, 5, 9]


def test_an_altered_answer_in_the_cohort_is_caught(monkeypatch):
    import sift3d_torch

    real = sift3d_torch.extract_features_many

    def one_altered(*a, **k):
        out = real(*a, **k)
        return [_altered(f) if i == len(out) - 1 else f for i, f in enumerate(out)]

    monkeypatch.setattr(sift3d_torch, "extract_features_many", one_altered)
    assert small_run("t1_cohort_b32")["correct"] is False


def test_half_the_batch_left_out_is_caught_at_the_cells_batch(monkeypatch):
    import sift3d_torch

    real = sift3d_torch.extract_features_many

    def half(imgs, *a, **k):
        out = real(imgs[: len(imgs) // 2], *a, **k)
        return out + out[: len(imgs) - len(out)]  # the rest's answers in the left-out slots

    monkeypatch.setattr(sift3d_torch, "extract_features_many", half)
    params = dict(OWN, batch=32, distinct=32, check_volumes=4)
    assert small_run("t1_cohort_b32", config=TINY, params=params)["correct"] is False


def test_an_altered_answer_in_the_single_loop_is_caught(monkeypatch):
    import sift3d_torch

    real = sift3d_torch.extract_features
    monkeypatch.setattr(sift3d_torch, "extract_features", lambda *a, **k: _altered(real(*a, **k)))
    assert small_run("t1_single")["correct"] is False


@pytest.mark.parametrize("stage", ["ratio", "hough", "vote"])
def test_an_altered_match_answer_is_caught(monkeypatch, stage):
    from sift3d_torch.match import groupvote, pairwise

    if stage == "ratio":
        real = pairwise.ratio_match_stacked

        def fake(*a, **k):
            out = real(*a, **k)
            out[0].db_idx = out[0].db_idx.copy()
            out[0].db_idx[0] += 1
            return out

        monkeypatch.setattr(pairwise, "ratio_match_stacked", fake)
    elif stage == "hough":
        real = pairwise.match_keys_stacked

        def fake(*a, **k):
            out = real(*a, **k)
            out[-1].transform.trans = out[-1].transform.trans * (1 + 1e-6)
            return out

        monkeypatch.setattr(pairwise, "match_keys_stacked", fake)
    else:
        real = groupvote.GroupMatcher.match_all_to_all

        def fake(self):
            res = real(self)
            res.votes = res.votes.copy()
            res.votes[0, 1] *= 1 + 1e-6
            return res

        monkeypatch.setattr(groupvote.GroupMatcher, "match_all_to_all", fake)
    assert small_run("t1_groupmatch32")["correct"] is False
