"""PyTorch port: batched extraction (extract_features_many) on the CPU.

- Against the JAX package's extract_features_many on the same list: the
  three 64^3 exact cells of test_torch_extract_e2e.py, a 48x56x64 volume (a
  second shape group) and a zero volume, at test_extract_matches_jax_exactly's
  tolerances; the zero volume gives an empty set on both. The 48x56x64 blob
  texture is seed 4, whose locations equal the JAX package's: at other seeds
  of that grid XLA's shape-dependent blur order (ROADMAP Queue 3) moves
  locations by up to about 3e-3, past the 1e-4 of the exact cells.
- Against the port's own extract_features on each volume alone: bit for bit
  on every field and in order, at B = 1, 2 and 4 with mixed shapes.
- The batched pieces against per-volume calls, exactly: the pyramid (whose
  plain blur runs volume by volume), K1's plain version, the candidate union
  (volume index and per-volume ranks), the fused K2's plain version with a
  volume index, and K4's plain versions on the flattened [B * 6, Z, Y, X]
  stack.
"""

import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.pipeline.extract import extract_features_many as jx_extract_many
from sift3d_torch import extract_features_many as exported
from sift3d_torch.core.config import SiftConfig
from sift3d_torch.kernels import extrema_cuda, patch_cuda
from sift3d_torch.pipeline import features, pyramid
from sift3d_torch.pipeline.extract import extract_features, extract_features_many
from sift3d_torch.utils.synthetic import repeatability, synthetic_blob_texture, synthetic_volume

torch.set_num_threads(1)
CFG = SiftConfig()
SIGMAS = tuple(CFG.level_sigmas())
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
NAMES = ["synthetic64_s3", "synthetic64_s7", "texture64", "texture48x56x64_s4", "zeros64"]


def _volumes():
    """test_torch_extract_e2e.py's EXACT_CELLS, a second shape and zeros."""
    return [
        synthetic_volume(64, seed=3),
        synthetic_volume(64, seed=7),
        synthetic_blob_texture((64, 64, 64), seed=7, n_blobs=30),
        synthetic_blob_texture((48, 56, 64), seed=4, n_blobs=30),
        np.zeros((64, 64, 64), np.float32),
    ]


@pytest.fixture(scope="module")
def volumes():
    return _volumes()


@pytest.fixture(scope="module")
def jax_many(volumes):
    return jx_extract_many(volumes, JxConfig())


@pytest.fixture(scope="module")
def port_many(volumes):
    return extract_features_many(volumes, device="cpu")


@pytest.fixture(scope="module")
def port_single(volumes):
    return [extract_features(v, device="cpu") for v in volumes]


def _assert_same(got, want):
    assert len(got) == len(want)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_many_matches_jax(jax_many, port_many, i):
    """test_extract_matches_jax_exactly's tolerances, volume by volume."""
    want, got = jax_many[i], port_many[i]
    assert len(jax_many) == len(port_many) == len(NAMES)
    if NAMES[i] == "zeros64":
        assert len(got) == len(want) == 0
        return
    assert len(got) == len(want) > 0
    assert repeatability(got, want)[0] == 1.0 and repeatability(want, got)[0] == 1.0
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ori, want.ori, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.eigs, want.eigs, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.info, want.info)
    assert (got.desc == want.desc).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_many_equals_single(port_many, port_single, i):
    _assert_same(port_many[i], port_single[i])


@pytest.mark.parametrize("order", [[3], [0, 3], [2, 3, 4, 1]], ids=["B1", "B2", "B4"])
def test_batch_sizes_keep_order_and_bits(volumes, port_single, order):
    """B = 1, 2 and 4 (mixed shapes, inputs out of their fixture order):
    each result equals that volume alone, in input order; tensors in, too."""
    got = exported([torch.from_numpy(volumes[i]) for i in order], device="cpu")
    assert len(got) == len(order)
    for g, i in zip(got, order):
        _assert_same(g, port_single[i])


def test_empty_list_and_the_card_default(monkeypatch):
    assert extract_features_many([], device="cpu") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features_many([np.zeros((8, 8, 8), np.float32)])


def _batch_octave(shape=(24, 28, 20), seeds=(1, 2, 3)):
    """Octave 0 of a batch of blob textures: (gstack [B, 6, ...], dogs
    [B, 5, ...], mask [B, 3, ...]), and the batch."""
    batch = torch.from_numpy(np.stack([synthetic_blob_texture(shape, seed=s, n_blobs=12) for s in seeds]))
    gstack, dogs, mask, _ = pyramid.octave_core(pyramid.initial_blur_core(batch, CFG), CFG)
    return gstack, dogs, mask, batch


@pytest.mark.parametrize("shape", [(24, 28, 20), (5, 6, 5)])
def test_batched_pyramid_equals_single(shape):
    """The pyramid of a batch equals each volume's own, to the bit, also
    at 5x6x5 (the deepest T1 octave), where the plain blur's batched matmul
    would sum in another order."""
    gstack, dogs, mask, batch = _batch_octave(shape)
    for b in range(batch.shape[0]):
        want = pyramid.octave_core(pyramid.initial_blur_core(batch[b], CFG), CFG)
        for got, w in zip((gstack[b], dogs[b], mask[b]), want):
            assert torch.equal(got, w)


def test_dogs_extrema_plain_batch_equals_single():
    gstack, _, _, _ = _batch_octave()
    dogs, mask = extrema_cuda.dogs_extrema_plain(gstack)
    routed = extrema_cuda.dogs_extrema(gstack)
    assert dogs.shape == (3, 5, *gstack.shape[2:]) and mask.shape == (3, 3, *gstack.shape[2:])
    for b in range(gstack.shape[0]):
        d, m = extrema_cuda.dogs_extrema_plain(gstack[b])
        assert torch.equal(dogs[b], d) and torch.equal(mask[b], m)
        assert torch.equal(routed[0][b], d) and torch.equal(routed[1][b], m)


def test_candidate_union_is_the_tables_concatenated():
    """Random sparse masks with an empty volume: (vi, lvl, zyx, sign) are
    the per-volume tables in volume order, rank each row's index in its own."""
    rng = np.random.default_rng(4)
    mask = rng.choice([-1, 0, 1], size=(4, 3, 9, 10, 11), p=[0.03, 0.94, 0.03]).astype(np.int8)
    mask[2] = 0
    mask = torch.from_numpy(mask)
    vi, lvl, zyx, sign, rank = features.candidate_union(mask)
    tables = [features.candidate_table(m) for m in mask]
    assert torch.equal(vi, torch.cat([torch.full((t[0].shape[0],), b) for b, t in enumerate(tables)]))
    assert torch.equal(rank, torch.cat([torch.arange(t[0].shape[0]) for t in tables]))
    for got, want in zip((lvl, zyx, sign), zip(*tables)):
        assert torch.equal(got, torch.cat(want))
    assert tables[2][0].shape[0] == 0 and lvl.shape[0] > 100


def test_gather_eig_plain_with_vi_equals_per_volume():
    gstack, dogs, mask, _ = _batch_octave()
    vi, lvl, zyx, _, _ = features.candidate_union(mask)
    assert torch.unique(vi).numel() == 3
    got = features.gather_eig_plain(gstack, dogs, lvl, zyx, SIGMAS, CFG, vi=vi)
    routed = features.gather_eig(gstack, dogs, lvl, zyx, SIGMAS, CFG, vi=vi)
    for b in range(gstack.shape[0]):
        sel = vi == b
        want = features.gather_eig_plain(gstack[b], dogs[b], lvl[sel], zyx[sel], SIGMAS, CFG)
        for g, r, w in zip(got, routed, want):
            assert torch.equal(g[sel], w) and torch.equal(r[sel], w)


def test_rotated_samplers_on_the_flattened_stack_equal_per_volume():
    rng = np.random.default_rng(6)
    gstack, _, _, _ = _batch_octave()
    nb, nl = gstack.shape[:2]
    r = 60
    vi = torch.from_numpy(rng.integers(0, nb, r))
    lvl = torch.from_numpy(rng.integers(1, 4, r))
    centers = torch.from_numpy(rng.uniform([-2, 3, 3], [22, 25, 21], (r, 3)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(1.0, 6.0, r).astype(np.float32))
    q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((r, 3, 3)).astype(np.float32)))
    oris = q.contiguous()
    flat = gstack.flatten(0, 1)
    glvl = (vi * nl + lvl).to(torch.int32)
    for plain in (patch_cuda.rotated_goh_plain, patch_cuda.sample_rotated_plain):
        got = plain(flat, glvl, centers, scales, oris)
        for b in range(nb):
            sel = vi == b
            want = plain(gstack[b], lvl[sel].to(torch.int32), centers[sel], scales[sel], oris[sel])
            assert torch.equal(got[sel], want), plain.__name__
