"""PyTorch port: the span tracer (``sift3d_torch.utils.timing``), on the CPU.

- Off (no profiler, no record): ``stage`` hands out one shared context,
  keeps no span and enters no ``record_function``.
- Under a CPU ``torch.profiler``: the extraction and matching entry points
  open their documented ``stage:`` ranges, nested as in the code.
- Recording: parents, top-level calls, self time (a span less the spans
  directly inside it), spans from four threads at once, and a generator
  abandoned after its first octave leaves no span open.
- No path synchronizes: ``torch.cuda.synchronize`` raises if called.
- ``featextract --time`` prints the record's table.
- On a CUDA card (marker ``cuda``): each span's pair of CUDA events gives
  its stream ms.
"""

import contextlib
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sift3d_torch.core.config import DEFAULT_CONFIG
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT, FeatureSet
from sift3d_torch.io import keyfile
from sift3d_torch.match import pairwise
from sift3d_torch.pipeline import pyramid
from sift3d_torch.pipeline.extract import extract_features, extract_features_many, extract_octaves
from sift3d_torch.utils import timing
from sift3d_torch.utils.synthetic import synthetic_volume
from sift3d_torch.utils.timing import TRACER, Tracer

torch.set_num_threads(1)

# the spans of one volume's extraction, in the order the code opens them;
# each octave's stages nest in its span "octave"
EXTRACT_SPANS = ["input", "initial_blur", "octave", "pyramid", "candidates", "gather_eig", "canonical", "descriptors",
                 "emit"]
OCTAVE_STAGES = ["pyramid", "candidates", "gather_eig", "canonical", "descriptors"]
MATCH_SPANS = ["hough_cap", "hough_hypotheses", "hough_vote", "refine"]
# the benchmark's own range names, which no span of the program may take
HARNESS_RANGES = {"stage:initial_blur", "stage:pyramid", "stage:candidates", "stage:gather_eig",
                  "stage:canonical", "stage:descriptors", "span:read", "span:ratio_match", "span:hough",
                  "span:group_vote"}


@pytest.fixture(scope="module")
def volume():
    return synthetic_volume(48, seed=7)  # 14 features, all in octave 0


def _rotation(rng):
    u, _, vt = np.linalg.svd(rng.standard_normal((3, 3)))
    r = u @ vt
    return r if np.linalg.det(r) > 0 else -r


@pytest.fixture(scope="module")
def pair():
    """A database of 80 features and a query set of 40 of them under a
    rotation about z and a shift: enough matches for a vote."""
    rng = np.random.default_rng(11)
    n = 80
    f1 = FeatureSet.empty(n)
    f1.xyz = rng.uniform(20, 80, (n, 3)).astype(np.float32)
    f1.scale = rng.uniform(2, 6, n).astype(np.float32)
    f1.ori = np.stack([_rotation(rng) for _ in range(n)]).astype(np.float32)
    f1.eigs = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    f1.info[:] = INFO_FLAG_REORIENT
    f1.desc = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (n, 1)), axis=1)
    sel = rng.choice(n, 40, replace=False)
    th = np.deg2rad(10.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    f2 = f1.select(sel)
    f2.xyz = ((f1.xyz[sel] - np.array([3.0, -2.0, 1.0])) @ rot).astype(np.float32)
    f2.ori = np.einsum("ji,njk->nik", rot, f1.ori[sel].transpose(0, 2, 1)).transpose(0, 2, 1).astype(np.float32)
    return f1, f2


@pytest.fixture
def fresh():
    """The process's tracer with an empty record, emptied again after."""
    TRACER.spans = []
    yield TRACER
    TRACER.spans = []


def _ranges(prof, tmp_path):
    """[(name without "stage:", start, end)] of the trace's stage ranges on
    the host, in order of start (read from the exported trace: a few times
    faster than the profiler's event list)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = [(e["name"][len(timing.PREFIX):], e["ts"], e["ts"] + e["dur"])
           for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation" and e["name"].startswith(timing.PREFIX)]
    return sorted(out, key=lambda r: r[1])


EPS_US = 0.01  # the exported trace's times are microseconds as floats: start + duration may round


def _inside(inner, outer) -> bool:
    return outer[1] - EPS_US <= inner[1] and inner[2] <= outer[2] + EPS_US


def _disjoint(ranges) -> bool:
    return all(a[2] <= b[1] + EPS_US for a, b in zip(ranges, ranges[1:]))


def test_off_keeps_nothing_and_opens_no_range(monkeypatch, fresh, volume, pair):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert TRACER.stage("a") is TRACER.stage("b")
    assert len(extract_features(volume, device="cpu")) > 0
    pairwise.match_keys_stacked(pair[0], [pair[1]], refine=True, device="cpu")
    assert TRACER.spans == []


def test_extraction_ranges_under_the_profiler(volume, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features(volume, device="cpu")
    ranges = _ranges(prof, tmp_path)
    assert sorted({n for n, _, _ in ranges}) == sorted(EXTRACT_SPANS)
    octaves = [r for r in ranges if r[0] == "octave"]
    # the entry's own spans follow one another, each octave's stages nest in it
    top = [r for r in ranges if not any(_inside(r, o) for o in octaves if o is not r)]
    assert _disjoint(top)
    names = [n for n, _, _ in top]
    n = pyramid.num_octaves(volume.shape, DEFAULT_CONFIG)
    # octave 0 alone emits rows: its FeatureSet follows it, the concatenation ends the call
    assert names == ["input", "initial_blur", "octave", "emit"] + ["octave"] * (n - 1) + ["emit"]
    first = [r for r in ranges if _inside(r, octaves[0]) and r is not octaves[0]]
    assert _disjoint(first)
    assert [n for n, _, _ in first] == OCTAVE_STAGES + ["emit"]  # octave 0 emits rows, sorted in "emit"
    later = [r[0] for o in octaves[1:] for r in ranges if r is not o and _inside(r, o)]
    assert later and set(later) <= set(OCTAVE_STAGES)  # no rows: no "emit" in a later octave
    # each new name is the program's own, none is one of the harness's ranges
    assert not {timing.PREFIX + n for n in ("input", "octave", "emit", *MATCH_SPANS, "key_rows")} & HARNESS_RANGES


def test_batched_extraction_ranges_nest_inside_a_callers_span(volume, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.stage("cohort"):
            extract_features_many([volume, volume], device="cpu")
    ranges = _ranges(prof, tmp_path)
    outer = [r for r in ranges if r[0] == "cohort"]
    inner = [r for r in ranges if r[0] not in ("cohort", *OCTAVE_STAGES) and not
             (r[0] == "emit" and any(_inside(r, o) for o in ranges if o[0] == "octave"))]
    assert len(outer) == 1 and all(_inside(r, outer[0]) for r in ranges if r is not outer[0])
    assert _disjoint(inner)
    names = [n for n, _, _ in inner]
    # one shape group: its batch filled in one span; the octaves, each followed
    # by its rows' copy to the host and split; the sets last
    assert names[:3] == ["input", "initial_blur", "octave"] and names[-1] == "emit"
    assert names.count("input") == 1
    assert {n for n, _, _ in ranges} == set(EXTRACT_SPANS) | {"cohort"}


def test_matching_ranges_under_the_profiler(pair, tmp_path):
    f1, f2 = pair
    path = str(tmp_path / "a.key")
    keyfile.write_text(f1, path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.stage("hough"):
            results = pairwise.match_keys_stacked(f1, [f2], refine=True, device="cpu")
        with TRACER.stage("read"):
            keyfile.read_text(path)
    assert results[0].num_inliers > 20
    ranges = _ranges(prof, tmp_path)
    hough = [r for r in ranges if r[0] == "hough"]
    read = [r for r in ranges if r[0] == "read"]
    steps = [r for r in ranges if r[0] in MATCH_SPANS]
    assert [n for n, _, _ in steps] == MATCH_SPANS
    assert len(hough) == 1 and all(_inside(r, hough[0]) for r in steps) and _disjoint(steps)
    rows = [r for r in ranges if r[0] == "key_rows"]
    assert len(read) == len(rows) == 1 and _inside(rows[0], read[0])


def test_self_time_is_the_span_less_its_children():
    tracer = Tracer()
    with tracer.record():
        with tracer.stage("outer"):
            time.sleep(0.002)
            with tracer.stage("inner"):
                time.sleep(0.003)
                with tracer.stage("leaf"):
                    time.sleep(0.001)
            with tracer.stage("inner"):
                time.sleep(0.001)
        with tracer.stage("outer"):
            pass
    spans = {s.id: s for s in tracer.spans}
    outer = [s for s in tracer.spans if s.name == "outer"]
    inner = [s for s in tracer.spans if s.name == "inner"]
    leaf = [s for s in tracer.spans if s.name == "leaf"]
    assert outer[0].parent is None and all(s.parent == outer[0].id for s in inner)
    assert leaf[0].parent == inner[0].id
    # every span belongs to the top-level span it ran under
    assert {s.call for s in inner + leaf} == {outer[0].id} and outer[1].call == outer[1].id
    assert all(s.events is None for s in spans.values())

    def ms(s):
        return (s.end_ns - s.start_ns) / 1e6

    totals = tracer.totals()
    assert list(totals) == ["outer", "inner", "leaf"]
    assert totals["outer"].calls == 2 and totals["inner"].calls == 2 and totals["leaf"].calls == 1
    assert totals["outer"].host_ms == pytest.approx(ms(outer[0]) + ms(outer[1]))
    assert totals["outer"].self_ms == pytest.approx(ms(outer[0]) + ms(outer[1]) - ms(inner[0]) - ms(inner[1]))
    assert totals["inner"].self_ms == pytest.approx(ms(inner[0]) + ms(inner[1]) - ms(leaf[0]))
    assert totals["leaf"].self_ms == totals["leaf"].host_ms
    assert 1.5 < totals["outer"].self_ms < totals["outer"].host_ms
    assert totals["outer"].stream_ms is None
    table = tracer.summary().splitlines()
    assert len(table) == 4 and table[1].split()[:2] == ["outer", "2"]


def test_spans_from_four_threads_all_come_back_with_their_own_parents():
    tracer = Tracer()
    threads, rounds = 4, 200
    start = threading.Barrier(threads)

    def work(k):
        start.wait(timeout=30)
        for _ in range(rounds):
            with tracer.stage(f"outer{k}"):
                with tracer.stage(f"inner{k}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracer.record():
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = {s.id: s for s in tracer.spans}
    assert len(spans) == len(tracer.spans) == threads * rounds * 2
    for s in spans.values():
        k = s.name[-1]
        if s.name.startswith("outer"):
            assert s.parent is None and s.call == s.id
        else:
            parent = spans[s.parent]
            assert parent.name == f"outer{k}" and parent.thread == s.thread and s.call == parent.id
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert len({s.thread for s in spans.values()}) == threads
    assert all(tracer.totals()[f"inner{k}"].calls == rounds for k in range(threads))


def test_nothing_synchronizes(monkeypatch, volume, pair, fresh):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with profile(activities=[ProfilerActivity.CPU]), TRACER.record("cpu"):
        extract_features(volume, device="cpu")
        pairwise.match_keys_stacked(pair[0], [pair[1]], refine=True, device="cpu")
    names = {s.name for s in TRACER.spans}
    assert names == set(EXTRACT_SPANS) | set(MATCH_SPANS)
    assert "canonical" in TRACER.summary()


def test_an_abandoned_octave_generator_leaves_no_span_open(volume, fresh):
    with TRACER.record():
        octaves = extract_octaves(volume, device="cpu")
        octave, rows = next(octaves)
        with TRACER.stage("probe"):
            pass
        del octaves
    assert octave == 0 and len(rows["xyz"]) > 0
    probe = [s for s in TRACER.spans if s.name == "probe"]
    assert len(probe) == 1 and probe[0].parent is None
    # every span the generator opened had ended before the probe began
    assert all(s.end_ns <= probe[0].start_ns for s in TRACER.spans if s.name != "probe")
    assert {"input", "emit"} <= {s.name for s in TRACER.spans}


def test_featextract_time_prints_the_record(tmp_path, volume, capsys, fresh):
    from sift3d_torch.cli import featextract
    from sift3d_torch.io import nifti

    src, out = str(tmp_path / "v.nii"), str(tmp_path / "v.key")
    nifti.write(src, volume)
    with contextlib.chdir(tmp_path):
        assert featextract.main(["--time", src, out], device="cpu") == 0
    printed = capsys.readouterr().out
    assert "self ms" in printed and "stream ms" in printed
    rows = {line.split()[0]: line.split() for line in printed.splitlines() if line.split()}
    assert all(name in rows for name in EXTRACT_SPANS)
    assert rows["input"][1] == "1" and rows["canonical"][-1] == "-"


@pytest.mark.cuda
def test_recording_on_the_card_gives_stream_ms(monkeypatch, volume):
    """Each span's pair of CUDA events on the card's current stream, and
    still no torch.cuda.synchronize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    tracer = Tracer()
    with tracer.record("cuda:0"):
        extract_features(volume, device="cuda:0", timer=tracer)
    totals = tracer.totals()
    assert set(totals) == set(EXTRACT_SPANS)
    assert all(t.stream_ms is not None and t.stream_ms >= 0 for t in totals.values())
    assert all(s.events is not None for s in tracer.spans)
