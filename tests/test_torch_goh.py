"""PyTorch port: the fused K4 (patch_cuda.rotated_goh: rotated patch and
GoH-64 rank descriptor; patch_cuda.goh: the descriptor of a given patch) on
the CPU, where they run their plain versions, against the JAX package; their
rows independent of the batch and of a Z slab; the rank formula against a
stable argsort with planted ties.

Tolerances: the uint8 rank rows equal the JAX package's on >= 99% of rows,
the bar of the other descriptor tests (test_torch_brief.py): XLA sums the
normalization, the splat's einsum and the norm in its own orders, so a tie
between two bins can break the other way. goh_descriptor's ascending chains
equal an einsum within f32 reassociation (1e-6 of the row's largest bin).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.kernels import patch as jx_patch
from sift3d.pipeline import features as jx_features
from sift3d_torch.kernels import descriptor, patch_cuda
from sift3d_torch.kernels.patch import normalize_patches, patch_gradients
from sift3d_torch.core.numerics import sqrt
from sift3d_torch.utils.synthetic import synthetic_blob_texture

torch.set_num_threads(1)
DIMS = (40, 44, 64)


@pytest.fixture(scope="module")
def gstack():
    vol = synthetic_blob_texture(DIMS, seed=5, n_blobs=40)
    return np.stack([vol * (1.0 - 0.1 * k) for k in range(6)]).astype(np.float32)


def _rows(rng, n, scale_hi, margin=4.0):
    lvl = rng.integers(1, 4, n).astype(np.int32)
    scales = rng.uniform(1.0, scale_hi, n).astype(np.float32)
    hi = np.array([DIMS[2], DIMS[1], DIMS[0]], np.float32)
    centers = rng.uniform(margin, hi - margin, (n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return lvl, centers, scales, (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _identical_rows(got, want):
    return float((got == want).all(axis=1).mean())


def test_goh_matches_jax_descriptor_stage():
    patches = np.random.default_rng(12).standard_normal((200, 11, 11, 11)).astype(np.float32)
    got = patch_cuda.goh(torch.from_numpy(patches)).numpy()
    want = np.asarray(jx_features.descriptor_stage(jnp.asarray(patches), "goh")).astype(np.uint8)
    assert got.dtype == np.uint8 and got.shape == (200, 64)
    np.testing.assert_array_equal(np.sort(got, axis=1), np.tile(np.arange(64, dtype=np.uint8), (200, 1)))
    assert _identical_rows(got, want) >= 0.99


@pytest.mark.parametrize("box", [24, 64])
def test_rotated_goh_matches_jax_boxed(rng, gstack, box):
    """Rows inside the JAX box's scale bound (the boxless kernel equals the
    boxed sampler only there; PERF.md, Queue 3)."""
    lvl, centers, scales, oris = _rows(rng, 120, float(jx_patch.rbox_max_scale(box)))
    got = patch_cuda.rotated_goh(*(torch.from_numpy(a) for a in (gstack, lvl, centers, scales, oris))).numpy()
    jp = jx_patch.sample_patches_rotated_boxed(
        jnp.asarray(gstack), jnp.asarray(lvl), jnp.asarray(centers), jnp.asarray(scales), jnp.asarray(oris), box=box,
    )
    want = np.asarray(jx_features.descriptor_stage(jp, "goh")).astype(np.uint8)
    assert _identical_rows(got, want) >= 0.99


def test_rows_do_not_depend_on_the_batch_or_a_slab(rng, gstack):
    """Each row's descriptor is bit-identical alone, in a batch of 7, in the
    whole set and from a Z slab (every sum in tree_sum's or the chains'
    fixed order); at large scales (above the 64^3 box's 8.80) and with
    points leaving the volume in x."""
    lvl, centers, scales, oris = _rows(rng, 40, 12.0, margin=-2.0)
    g = torch.from_numpy(gstack)
    rows = [torch.from_numpy(a) for a in (lvl, centers, scales, oris)]
    whole = patch_cuda.rotated_goh(g, *rows)
    assert (scales > 8.80).any() and ((centers[:, 0] < 5) | (centers[:, 0] > DIMS[2] - 5)).any()
    for sel in ([0], [39], list(range(5, 12))):
        assert torch.equal(patch_cuda.rotated_goh(g, *(t[sel] for t in rows)), whole[sel])
    pn = normalize_patches(patch_cuda.sample_rotated(g, *rows))
    whole_pn = patch_cuda.goh(pn)
    for sel in ([3], list(range(20, 27))):
        assert torch.equal(patch_cuda.goh(pn[sel].contiguous()), whole_pn[sel])
    # a slab holding every read of small rows near the middle of z
    small = [torch.from_numpy(a) for a in _rows(rng, 12, 2.0)]
    small[1][:, 2] = torch.from_numpy(rng.uniform(25.0, 39.0, 12).astype(np.float32))
    z0, z1 = 14, 50  # reach 2 * sqrt(3) * 2.0 + 2 < 9 planes
    got = patch_cuda.rotated_goh(g[:, z0:z1].contiguous(), *small, z0, DIMS[0])
    assert torch.equal(got, patch_cuda.rotated_goh(g, *small))


def test_rank_formula_is_a_stable_argsort(rng):
    """The fused K4's rank, #{j: v_j < v_i} + #{j < i: v_j == v_i}, in numpy,
    against rank_normalize's stable argsort (its plain version)."""
    x = rng.integers(0, 6, (50, 64)).astype(np.float32)  # many ties
    x[0] = 0.0  # a flat row: ranks in index order
    x[1, ::2] = -0.0  # -0 and +0 tie
    x[2] = rng.standard_normal(64)  # no ties
    vi, vj = x[:, :, None], x[:, None, :]
    earlier = np.arange(64)[None, :] < np.arange(64)[:, None]  # [i, j]: j < i
    counted = ((vj < vi) | ((vj == vi) & earlier)).sum(-1).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(descriptor.rank_normalize(t).numpy(), counted)
    assert torch.equal(descriptor.rank_normalize(t[:1]), torch.arange(64, dtype=t.dtype)[None])


def test_goh_chains_equal_an_einsum_up_to_reassociation():
    pn = normalize_patches(torch.from_numpy(
        np.random.default_rng(3).standard_normal((30, 11, 11, 11)).astype(np.float32)))
    got = descriptor.goh_descriptor(pn)
    gx, gy, gz = patch_gradients(pn).unbind(1)
    mag = sqrt(gx * gx + gy * gy + gz * gz)
    obin = torch.argmax(torch.stack([gx * d[0] + gy * d[1] + gz * d[2] for d in descriptor.ORI_DIRS.tolist()], 1), 1)
    w = torch.nn.functional.one_hot(obin, 8).float() * mag[..., None]
    wt = torch.from_numpy(descriptor.spatial_weight_table().copy())
    want = torch.einsum("czyxo,za,yb,xd->cabdo", w.double(), wt.double(), wt.double(), wt.double())
    want = want.reshape(30, 64).float()
    assert torch.allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
