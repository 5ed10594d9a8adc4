"""The work counts against counts worked by hand."""

import pytest

import roofline


def test_octave_shapes():
    assert roofline.octave_shapes((182, 218, 182)) == [
        (182, 218, 182), (91, 109, 91), (45, 54, 45), (22, 27, 22), (11, 13, 11), (5, 6, 5)]
    assert roofline.octave_shapes((8, 8, 8)) == [(8, 8, 8), (4, 4, 4)]


def test_pyramid_bytes_by_hand():
    # 8^3: octaves 8^3 (512 voxels) and 4^3 (64); s = 3 -> 6 levels, 5 DoGs, 3 extrema planes
    def octave(v, v_next, first):
        b = 2 * v * 4 if first else 0  # initial blur
        b += 5 * 2 * v * 4  # five blurs
        b += (6 + 5) * v * 4 + 3 * v  # DoG + extrema
        b += v * 4 + v_next * 4  # subsample
        return b
    want = octave(512, 64, True) + octave(64, 8, False)
    assert roofline.pyramid_bytes((8, 8, 8), 1) == want == 512 * 99 + 64 * 4 + 64 * 91 + 8 * 4
    assert roofline.pyramid_bytes((8, 8, 8), 3) == 3 * want


def test_knn_ops_and_bound():
    assert roofline.knn_int8_ops(10) == 2 * 10 * 10 * 64
    ms, by = roofline.bound(3.35e9, 0.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(0.0, 0.0, 1.979e12)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_device_busy_is_a_union_and_the_readers_read_it():
    import importlib.util
    import types

    from conftest import BENCH
    from devtrace import Trace, union

    assert union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]
    # 1 s busy in a 2 s window; the pyramid's and the vote's ranges hold all of it
    trace = Trace((0.0, 2e6), {0: union([(0.0, 6e5), (4e5, 1e6)])}, [], 10,
                  {"stage:initial_blur": [(0.0, 5e5)], "stage:pyramid": [(5e5, 1e6)], "span:group_vote": [(0.0, 1e6)]})
    ctx = types.SimpleNamespace(trace=trace, devices=[0], units=1, calls=1, config={"grid_zyx": [182, 218, 182]},
                                roofline=roofline, state={"vote_rows": 31008})

    def read(name):
        spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(ctx)

    assert read("idle_share") == pytest.approx(0.5)
    assert read("pyramid_roofline") == pytest.approx(100 * roofline.pyramid_bytes((182, 218, 182), 1) / 3.35e12)
    assert read("vote_roofline") == pytest.approx(100 * 2 * 31008**2 * 64 / 1979e12)
    assert read("launches_per_volume") == 10
    assert read("pyramid_ms") == pytest.approx(1000.0)
