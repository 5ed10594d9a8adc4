"""PyTorch port: the placement's own spans and counters
(``sift3d_torch.dist.batch``) on the CPU, every mesh entry "cpu".

``place`` and ``place_tail`` open on the calling thread, so that a
profiler that records only the thread which started it (torch's default)
still names the placement's host time; ``place_tail`` lies inside
``place`` and is not opened for a one-entry mesh; ``placed_volumes`` and
``placed_entries`` count a call while ``TRACER`` records.
"""

import threading

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from sift3d_torch.dist.batch import extract_features_batch
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
