"""The reference against the port's CPU path: equal where the two must
round alike (the port is held to the JAX package's compiled CPU program
bit for bit by the repository's own tests), within the limits end to end;
and its control against the reference, beyond them."""

import types

import numpy as np
import pytest

import compare
from reference import extract as ref_extract
from reference.extract import features
from reference.match import group
from traffic import keysets
from traffic.volumes import host_volumes

GRID = (64, 72, 64)
LIM_X = compare.LIMITS["extraction"]["feature_rows_off_share"]
LIM_M = compare.LIMITS["match"]


@pytest.fixture(scope="module")
def volumes():
    return host_volumes(GRID, 11, 2, 120, "cpu")


def test_parabola_vertex_rounds_as_the_jax_package_compiled():
    import torch

    from sift3d_torch.kernels.extrema import quadratic_interp_1d

    rng = np.random.default_rng(0)
    n = 200_000
    x = rng.integers(1, 180, n).astype(np.float32)
    fc = rng.uniform(5, 40, n).astype(np.float32)
    flo = (fc * (1 - rng.uniform(0, 0.02, n))).astype(np.float32)
    fhi = (fc * (1 - rng.uniform(0, 0.02, n))).astype(np.float32)
    t = [torch.from_numpy(a) for a in (flo, fc, fhi, x - 1, x, x + 1)]
    want = quadratic_interp_1d(*t).numpy()
    got = ref_extract.parabola_vertex(flo, fc, fhi, x - 1, x, x + 1)
    assert np.array_equal(got, want)


def test_gaussian_taps_are_the_ports():
    from sift3d_torch.kernels.gauss import gaussian_kernel_1d

    for sigma in (0.5, 0.95, 1.2262, 1.5199, 1.9230, 2.4228, 3.0525):
        assert np.array_equal(ref_extract.gaussian_taps(sigma, 0.01), gaussian_kernel_1d(sigma, 0.01))


def test_reference_extraction_agrees_with_the_ports_cpu_path(volumes):
    from sift3d_torch import extract_features

    for vol in volumes:
        want = features(vol, {}, "goh")
        got = extract_features(vol, device="cpu")
        assert len(want["xyz"]) > 20
        assert compare.share(*compare.feature_rows_off(got, want)) <= LIM_X


def test_the_extraction_control_is_beyond_the_limit(volumes):
    want = features(volumes[0], {}, "goh")
    ctrl = features(volumes[0], {}, "goh", control=True)
    assert compare.share(*compare.feature_rows_off(ctrl, want)) > LIM_X


def test_rows_off_counts_a_moved_a_dropped_and_an_altered_row(volumes):
    want = features(volumes[0], {}, "goh")
    assert compare.feature_rows_off(want, want) == (0, 2 * len(want["xyz"]))
    moved = dict(want, xyz=want["xyz"].copy())
    moved["xyz"][0] += want["scale"][0] * 2 * compare.XYZ_TOL
    assert compare.feature_rows_off(moved, want)[0] == 2
    dropped = {k: v[1:] for k, v in want.items()}
    assert compare.feature_rows_off(dropped, want)[0] == 1
    altered = dict(want, desc=want["desc"].copy())
    altered["desc"][0] = altered["desc"][0][::-1]
    assert compare.feature_rows_off(altered, want)[0] == 2


def _port_group(paths):
    import dataclasses

    from sift3d_torch.core.config import DEFAULT_CONFIG
    from sift3d_torch.io import keyfile
    from sift3d_torch.match.groupvote import GroupMatcher
    from sift3d_torch.match.pairwise import match_keys_stacked, ratio_match_stacked

    cfg = dataclasses.replace(DEFAULT_CONFIG, knn_neighbors=5)
    sets = [keyfile.read_text(p, eig_threshold=cfg.eig_threshold)[0].remove_non_reoriented() for p in paths]
    ratio = ratio_match_stacked(sets[1:], sets[0], cfg, "cpu")
    pairs = match_keys_stacked(sets[0], sets[1:], cfg, refine=True, matches=ratio, device="cpu")
    vote = GroupMatcher(sets, list(range(len(sets))), -1.0, cfg, "cpu").match_all_to_all()
    return compare.match_output(dict(sets=sets, ratio=ratio, pairs=pairs, vote=vote))


@pytest.fixture(scope="module")
def key_paths(tmp_path_factory):
    params = dict(count=6, rows=200, max_rot_deg=15, scale_lo=0.9, scale_hi=1.1, max_shift=10, loc_noise=0.7,
                  scale_noise=0.05, ori_noise=0.05, desc_noise=0.8, replaced=1 / 3)
    return keysets.write_group(keysets.group(5, params, (182, 218, 182), 6), str(tmp_path_factory.mktemp("keys")))


def test_reference_match_agrees_with_the_ports_cpu_path(key_paths):
    want = compare.match_output(group(key_paths, 5))
    assert min(p["num_inliers"] for p in want["pairs"]) > 50
    numbers = compare.match_numbers(_port_group(key_paths), want)
    assert numbers["match_rows_off"] == 0
    assert all(v <= LIM_M[k] for k, v in numbers.items()), numbers


def test_the_match_control_is_beyond_the_limits(key_paths):
    want = compare.match_output(group(key_paths, 5))
    numbers = compare.match_numbers(compare.match_output(group(key_paths, 5, control=True)), want)
    beyond = {k for k, v in numbers.items() if v > LIM_M[k]}
    assert {"match_rows_off", "transform_gap", "vote_gap"} <= beyond, numbers


def test_match_output_takes_the_programs_objects():
    t = types.SimpleNamespace(scale=1.5, rot=np.eye(3), trans=np.ones(3))
    pair = types.SimpleNamespace(model_idx=[0, 1], input_idx=[2, 3], inlier=[True, False], num_inliers=1, transform=t)
    out = compare.match_output(dict(sets=[], ratio=[], pairs=[pair], vote=types.SimpleNamespace(
        votes=np.zeros((1, 1)), counts=np.zeros((1, 1), int), log_likelihood=np.zeros((1, 1)))))
    assert out["pairs"][0]["scale"] == 1.5 and out["pairs"][0]["inlier"].tolist() == [True, False]
