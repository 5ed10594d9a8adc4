"""PyTorch port: the placement's own spans and counters
(``sift3d_torch.dist.batch``) on the CPU, every mesh entry "cpu".

``place`` and ``place_tail`` open on the calling thread, so that a
profiler that records only the thread which started it (torch's default)
still names the placement's host time; ``place_tail`` lies inside
``place`` and is not opened for a one-entry mesh; ``placed_volumes`` and
``placed_entries`` count a call while ``TRACER`` records.

The copy route, through the card's route on a CPU staging ring: a call
over four entries stages every volume on ``staging.shared_copy`` with
``copy_threads(4)`` threads (numpy's copy only) and counts them as
``shared_copy_volumes``; a one-entry call, ``extract_features_many``,
``extract_features`` and ``device_volume`` keep torch's copy for a batch
and numpy's for one volume, and count none.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sift3d_torch.dist import batch
from sift3d_torch.dist.batch import extract_features_batch
from sift3d_torch.pipeline import extract, staging
from sift3d_torch.pipeline.extract import extract_features, extract_features_many
from sift3d_torch.utils.synthetic import synthetic_volume
from sift3d_torch.utils.timing import TRACER

CALLER = "test:caller"


def _ranges(events, name):
    return [e for e in events if e.name == name]


def _traced(vols, mesh):
    """The call under a CPU profiler and TRACER.record(): (profiler
    events, recorded spans, counters)."""
    with TRACER.record(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            extract_features_batch(vols, mesh)
    return prof.events(), list(TRACER.spans), dict(TRACER.counts)


@pytest.fixture(scope="module")
def four_entries():
    """Five 48^3 volumes over four entries: groups of 2, 1, 1, 1."""
    return _traced([synthetic_volume(48, seed=s) for s in (3, 5, 7, 9, 11)], ["cpu"] * 4)


def test_place_and_place_tail_are_ranges_on_the_calling_thread(four_entries):
    events, spans, _ = four_entries
    (caller,) = _ranges(events, CALLER)
    (place,) = _ranges(events, "stage:place")
    (tail,) = _ranges(events, "stage:place_tail")
    assert place.thread == tail.thread == caller.thread
    assert place.time_range.start <= tail.time_range.start <= tail.time_range.end <= place.time_range.end
    assert tail.time_range.end > tail.time_range.start
    # the same in the tracer's record: both on this thread, place_tail nested in place
    ours = {s.name: s for s in spans if s.thread == threading.get_ident()}
    assert {"place", "place_tail"} <= set(ours)
    assert ours["place"].parent is None and ours["place_tail"].parent == ours["place"].id


def test_placement_counters_count_a_call(four_entries):
    _, _, counts = four_entries
    assert counts["placed_volumes"] == 5 and counts["placed_entries"] == 4


@pytest.mark.parametrize("mesh", [["cpu"], ["cpu"] * 4])
def test_one_entry_opens_no_place_tail(mesh):
    """A one-entry mesh, and a mesh of four given one volume, place on one
    entry: no tail."""
    events, spans, counts = _traced([synthetic_volume(48, seed=3)], mesh)
    assert len(_ranges(events, "stage:place")) == 1 and not _ranges(events, "stage:place_tail")
    assert "place_tail" not in {s.name for s in spans}
    assert counts["placed_volumes"] == 1 and counts["placed_entries"] == 1


FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")


@pytest.fixture
def cpu_ring(monkeypatch):
    """Host arrays bound for the CPU go through one CPU ring of two
    60-element slots, as they would through a card's; the ring's copies
    and shared_copy's thread counts are logged."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", 4 * 60)
    monkeypatch.setattr(staging, "DEPTH", 2)
    ring = staging.StagingRing("cpu")
    monkeypatch.setattr(extract, "_staged", lambda img, dev: not isinstance(img, torch.Tensor))
    monkeypatch.setattr(staging, "ring", lambda dev: ring)
    log = {"copies": set(), "threads": set()}
    for name in ("_numpy_copy", "_tensor_copy"):
        monkeypatch.setattr(staging, name, lambda d, s, f=getattr(staging, name), n=name: (log["copies"].add(n), f(d, s)))
    fill_shared = staging.StagingRing._fill_shared
    monkeypatch.setattr(staging.StagingRing, "_fill_shared",
                        lambda self, src, slot, lo, hi, k: (log["threads"].add(k), fill_shared(self, src, slot, lo, hi, k)))
    return log


def _counted(fn):
    with TRACER.record():
        out = fn()
        return out, dict(TRACER.counts)


def test_four_entries_stage_every_volume_on_the_shared_copy(cpu_ring):
    """Five volumes over four entries (groups of 2, 1, 1, 1): every volume
    on the shared route at the rule's k, each group's FeatureSets those of
    extract_features_many on its plain path."""
    vols = [synthetic_volume(32, seed=s) for s in (3, 5, 7, 9, 11)]
    got, counts = _counted(lambda: extract_features_batch(vols, ["cpu"] * 4))
    assert counts["shared_copy_volumes"] == counts["staged_volumes"] == counts["placed_volumes"] == 5
    assert cpu_ring == {"copies": {"_numpy_copy"}, "threads": {batch.copy_threads(4)}}
    for e in range(4):
        want = extract_features_many([torch.from_numpy(v) for v in vols[e::4]], device="cpu")
        for g, w in zip(got[e::4], want):
            for k in FIELDS:
                a, b = getattr(g, k), getattr(w, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), (e, k)


@pytest.mark.parametrize("call, copy", [("one_entry", "_tensor_copy"), ("many", "_tensor_copy"),
                                        ("single", "_numpy_copy"), ("device_volume", "_numpy_copy")])
def test_one_entry_and_the_unplaced_entries_keep_their_copies(cpu_ring, call, copy):
    vols = [synthetic_volume(32, seed=s) for s in (3, 5)]
    calls = {"one_entry": lambda: extract_features_batch(vols, ["cpu"]),
             "many": lambda: extract_features_many(vols, device="cpu"),
             "single": lambda: extract_features(vols[0], device="cpu"),
             "device_volume": lambda: extract.device_volume(vols[0], "cpu")}
    _, counts = _counted(calls[call])
    assert counts["shared_copy_volumes"] == 0 and counts["staged_volumes"] == (2 if copy == "_tensor_copy" else 1)
    assert cpu_ring == {"copies": {copy}, "threads": set()}
