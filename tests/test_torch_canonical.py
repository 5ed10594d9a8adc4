"""PyTorch port: the fused canonical stage (``hist_cuda.canonical_orientations``,
``sift3d_canonical`` in ``csrc/hist_topk.cu``) against its plain version
``features.canonical_stage_plain``.

On the CPU: ``canonical_stage`` takes the plain route (it never builds the
kernels and counts no launch) and returns the plain stage's rows; kvalid
drops the secondaries of dead rows and nothing else; the wrapper refuses
what the kernels do not take; while ``TRACER`` records, an extraction
counts ``canonical_rows`` (its unoriented rows) and ``reoriented_rows``
(its reoriented copies).

On a CUDA card (marker ``cuda``, skipped without one): the fused route
equals the plain stage run on the CPU bit for bit, on every entry of ori
and ori_valid: seeded normalized patches, all-zero patches, rows with no
peak, rows with six live primaries, ramps whose projections vanish (the
(1, 0, 0) fallback), kvalid masking, C = 0 and C = 1, and the rows of a 48^3
extraction; and it makes no host sync (CUDA's sync debug mode). This file
imports no JAX: on the card run
python -m pytest --noconftest -q -m cuda tests/test_torch_canonical.py
"""

import numpy as np
import pytest
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.kernels import cuda_lib, hist_cuda
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.kernels.patch import normalize_patches
from sift3d_torch.pipeline import features
from sift3d_torch.pipeline.extract import extract_features
from sift3d_torch.utils.synthetic import synthetic_volume
from sift3d_torch.utils.timing import TRACER

torch.set_num_threads(1)
CFG = SiftConfig()
K1, K2 = CFG.max_primary_orientations, CFG.max_secondary_orientations


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return normalize_patches(torch.from_numpy(rng.standard_normal((n, 11, 11, 11)).astype(np.float32)))


def _ramps(directions, floor=-torch.inf):
    """Normalized linear ramps along each (x, y, z) direction, clamped
    below at floor: every gradient is the same up to rounding, or 0 where
    the ramp lies flat, so the projections perpendicular to the primary
    all but vanish, and vanish where the gradient does."""
    r = torch.arange(11, dtype=torch.float32) - 5.0
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    ramps = [torch.clamp(a * x + b * y + c * z, min=floor) for a, b, c in directions]
    return normalize_patches(torch.stack(ramps))


def _live_primaries(pn):
    """Live primary slots a row (valid1 of the plain stage)."""
    e3, w = features.sphere_edges(pn)
    v1, pk1, _ = features.hist_tops(*features.splat_coords(e3), w, features.ori_hist_band(CFG, "cpu"), K1)
    return (pk1 & (v1 >= CFG.ori_peak_threshold * v1[:, :1]) & (v1 > 0)).sum(1)


def _same(got, want):
    """Equal bits on every entry of ori (signed zeros included) and ori_valid."""
    return (torch.equal(got["ori"].cpu().view(torch.int32), want["ori"].view(torch.int32))
            and torch.equal(got["ori_valid"].cpu(), want["ori_valid"]))


@pytest.fixture(scope="module")
def extraction():
    """A 48^3 extraction on the CPU while TRACER records: its features, the
    counters, and each octave's (pn, plain stage output)."""
    rows = []
    plain = features.canonical_stage

    def keep(pn, cfg, kvalid=None):
        out = plain(pn, cfg, kvalid)
        rows.append((pn.clone(), out))
        return out

    with pytest.MonkeyPatch.context() as mp, TRACER.record():
        mp.setattr(features, "canonical_stage", keep)
        feats = extract_features(synthetic_volume(48, seed=7), CFG, device="cpu")
        counts = dict(TRACER.counts)
    return feats, counts, rows


# --- on the CPU -------------------------------------------------------------


def test_the_cpu_route_is_the_plain_stage_and_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    monkeypatch.setattr(cuda_lib, "library", no_build)
    before = launches("sift3d_canonical")
    for pn in (_noise(24, 5), _noise(1, 6)):
        got = features.canonical_stage(pn, CFG)
        want = features.canonical_stage_plain(pn, CFG)
        assert got["ori_valid"].shape == (pn.shape[0], K1, K2)
        assert _same(got, want)
    assert launches("sift3d_canonical") == before


def test_kvalid_drops_the_secondaries_of_dead_rows_only():
    pn = _noise(16, 8)
    kvalid = torch.from_numpy(np.random.default_rng(9).random(16) < 0.5)
    whole = features.canonical_stage(pn, CFG)
    got = features.canonical_stage(pn, CFG, kvalid)
    live = kvalid[:, None, None]
    assert torch.equal(got["ori_valid"], whole["ori_valid"] & live)
    dead = torch.zeros_like(whole["ori"])
    assert torch.equal(got["ori"], torch.where(live[..., None, None], whole["ori"], dead))
    assert whole["ori_valid"][~kvalid].any() and got["ori_valid"][kvalid].any()


def test_an_extraction_counts_its_canonical_and_reoriented_rows(extraction):
    feats, counts, rows = extraction
    n_reor = int(feats.is_reoriented.sum())
    assert n_reor > 0 and rows
    assert counts["canonical_rows"] == len(feats) - n_reor == sum(pn.shape[0] for pn, _ in rows)
    assert counts["reoriented_rows"] == n_reor
    assert "reoriented_rows" in TRACER.summary()


def _bad_call(name):
    pn, band = torch.zeros((3, 11, 11, 11)), features.ori_hist_band(CFG, "cpu")
    ok = dict(pn=pn, band=band, k1=K1, k2=K2, thr1=0.8, thr2=0.5, kvalid=None)
    return {
        "k1 of 0": (dict(ok, k1=0), "k1 and k2"),
        "k2 of 84": (dict(ok, k2=84), "k1 and k2"),
        "pn of rank 3": (dict(ok, pn=torch.zeros((3, 11, 121))), "pn must be"),
        "pn of 12^3": (dict(ok, pn=torch.zeros((3, 12, 12, 12))), "pn must be"),
        "pn in f64": (dict(ok, pn=pn.double()), "pn must be"),
        "kvalid of another length": (dict(ok, kvalid=torch.ones(4, dtype=torch.bool)), "kvalid must be"),
        "kvalid in uint8": (dict(ok, kvalid=torch.ones(3, dtype=torch.uint8)), "kvalid must be"),
        "band of 10 x 11": (dict(ok, band=band[:10]), "band must be"),
        "band not contiguous": (dict(ok, band=band.t()), "band must be"),
        "pn on the CPU": (ok, "must be a CUDA tensor"),
    }[name]


BAD_CALLS = ["k1 of 0", "k2 of 84", "pn of rank 3", "pn of 12^3", "pn in f64", "kvalid of another length",
             "kvalid in uint8", "band of 10 x 11", "band not contiguous", "pn on the CPU"]


@pytest.mark.parametrize("case", BAD_CALLS)
def test_the_wrapper_refuses_what_the_kernels_do_not_take(case):
    kwargs, message = _bad_call(case)
    before = launches("sift3d_canonical")
    with pytest.raises(ValueError, match=message):
        hist_cuda.canonical_orientations(**kwargs)
    assert launches("sift3d_canonical") == before


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(name):
    """A case's patches, and the live primaries each of its rows must have
    (None: any)."""
    if name == "seeded noise":
        return _noise(96, 10), None
    if name == "zeros":
        return torch.zeros((5, 11, 11, 11)), 0
    if name == "no peak":  # constants and ramps along the axes peak on the border
        return torch.cat([normalize_patches(torch.ones((2, 11, 11, 11))),
                          _ramps([(1.0, 0.0, 0.0), (0.0, -1.0, 0.0)])]), 0
    if name == "six live primaries":
        six = _noise(256, 11)
        return six[_live_primaries(six) == K1][:24], K1
    if name == "vanishing projections":
        return _ramps([(1.0, 1.0, 1.0), (1.0, -2.0, 0.5), (2.0, 1.0, 1.0)], floor=0.0), 1
    return _noise(int(name[-1]), 12), None  # "C = 0", "C = 1"


CASES = ["seeded noise", "zeros", "no peak", "six live primaries", "vanishing projections", "C = 0", "C = 1"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_the_fused_stage_equals_the_plain_stage_on_the_card(card, case):
    pn, live = _case(case)
    if live is not None:
        assert pn.shape[0] > 0 and _live_primaries(pn).tolist() == [live] * pn.shape[0]
    before = launches("sift3d_canonical")
    got = features.canonical_stage(pn.to(card), CFG)
    torch.cuda.synchronize()
    assert launches("sift3d_canonical") == before + (pn.shape[0] > 0)
    assert got["ori"].device == card
    if pn.shape[0] == 0:  # no launch; the plain stage takes no empty octave (emit_candidates returns first)
        assert got["ori"].shape == (0, K1, K2, 3, 3) and got["ori_valid"].shape == (0, K1, K2)
    else:
        assert _same(got, features.canonical_stage_plain(pn, CFG)), case


@pytest.mark.cuda
def test_kvalid_masks_the_fused_stage_as_the_plain_one(card):
    pn = _noise(64, 14)
    kvalid = torch.from_numpy(np.random.default_rng(15).random(64) < 0.6)
    want = features.canonical_stage_plain(pn, CFG, kvalid)
    assert _same(features.canonical_stage(pn.to(card), CFG, kvalid.to(card)), want)
    none = torch.zeros(64, dtype=torch.bool)
    got = features.canonical_stage(pn.to(card), CFG, none.to(card))
    assert _same(got, features.canonical_stage_plain(pn, CFG, none)) and not got["ori_valid"].any()


@pytest.mark.cuda
def test_the_fused_stage_equals_the_plain_stage_on_a_48_cube_extraction(card, extraction):
    _, _, rows = extraction
    for pn, want in rows:
        assert _same(features.canonical_stage(pn.to(card), CFG), want), pn.shape[0]


@pytest.mark.cuda
def test_the_fused_stage_waits_for_nothing(card):
    """No host sync inside the fused route: CUDA's sync debug mode turns
    any into an error."""
    pn = _noise(32, 16).to(card)
    kvalid = torch.ones(32, dtype=torch.bool, device=card)
    features.canonical_stage(pn, CFG)  # the build and the band's cache first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = features.canonical_stage(pn, CFG, kvalid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _same(got, features.canonical_stage_plain(pn.cpu(), CFG))
