"""PyTorch port: the fused BRIEF kernels' plain versions (patch_cuda.brief_plain
on given patches, rotated_brief_plain on K4's rotated patches) against the
JAX package's descriptor_stage on the same patches, for every variant and
pair table; the rank the kernel computes (NaN last, ties by index) against
rank_normalize; the pair table made once a device; the rows independent of
the batch and of a Z slab.

Tolerance: the uint8 rank rows are equal on every row, except where an f64
replay (normalization, the sigma-0.95 pre-blur and the pair differences in
f64 from the same f32 patch) puts a comparison that decides a rank within
BOUND of the normalized patch's peak: the classified BRIEF pre-blur gap
(XLA's einsum order, at most 4e-8 of the peak, ROADMAP Queue 3) and
XLA's reduce-window sums of the normalization. Such rows are counted and
named by the assertion; at these seeds there are none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.kernels import descriptor as jx_descriptor
from sift3d.kernels import patch as jx_patch
from sift3d.pipeline import features as jx_features
from sift3d_torch.kernels import descriptor, patch_cuda
from sift3d_torch.kernels.gauss import banded_matrix
from sift3d_torch.kernels.patch import normalize_patches, rbox_max_scale
from sift3d_torch.pipeline import features
from sift3d_torch.utils.synthetic import synthetic_blob_texture

torch.set_num_threads(1)
BOUND = 2e-7  # of the normalized patch's peak |value|
DIMS = (40, 44, 64)
VARIANTS = ("brief", "rrief", "nrrief")
CASES = [(v, m) for v in VARIANTS for m in range(5)]

_jx_brief = jax.jit(jx_descriptor.brief_descriptor, static_argnames=("variant", "method", "blur_sigma"))


@pytest.fixture(scope="module")
def gstack():
    vol = synthetic_blob_texture(DIMS, seed=5, n_blobs=40)
    return np.stack([vol * (1.0 - 0.1 * k) for k in range(6)]).astype(np.float32)


@pytest.fixture(scope="module")
def rotated_patches(gstack):
    """160 rotated rows inside the 64^3 box's scale bound (8.80), where the
    JAX CPU path does not saturate, as (rows, the port's patches)."""
    rng = np.random.default_rng(31)
    n = 160
    lvl = rng.integers(1, 4, n).astype(np.int32)
    scales = rng.uniform(1.0, rbox_max_scale(64), n).astype(np.float32)
    hi = np.array([DIMS[2], DIMS[1], DIMS[0]], np.float32)
    centers = rng.uniform(2.0, hi - 2.0, (n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    oris = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    rows = [torch.from_numpy(a) for a in (gstack, lvl, centers, scales, oris)]
    return rows, patch_cuda.sample_rotated_plain(*rows).numpy()


def _f64_values(patches, variant, method):
    """The variant's 64 values of each patch in f64: normalization, the
    pre-blur (the f32 taps, zero borders, x then y then z) and the pair
    differences."""
    x = patches.reshape(len(patches), -1).astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    norm = np.sqrt((x * x).sum(axis=1, keepdims=True))
    x = (x / np.where(norm > 0, norm, 1.0)).reshape(patches.shape)
    band = banded_matrix(11, 0.95, 0.01).astype(np.float64)
    b = np.einsum("nzyx,xa->nzya", x, band)
    b = np.einsum("nzyx,yb->nzbx", b, band)
    b = np.einsum("nzyx,zc->ncyx", b, band)
    flat, dist = (t.numpy() for t in descriptor.brief_pairs(method, torch.device("cpu")))
    b = b.reshape(len(b), -1)
    d = b[:, flat[0]] - b[:, flat[1]]
    return (d / dist if variant == "nrrief" else d), np.abs(x).reshape(len(x), -1).max(axis=1)


def _order(v):
    """[n, 64, 64]: whether value i sorts before value j in a stable sort."""
    i = np.arange(v.shape[1])
    return (v[:, :, None] < v[:, None, :]) | ((v[:, :, None] == v[:, None, :]) & (i[:, None] < i[None, :]))


def _hold_to_jax(got, patches, variant, method):
    """got (uint8 [n, 64]) against JAX's descriptor_stage on the same
    patches: every row equal, or each comparison that decides a differing
    rank within BOUND of the f64 replay. Returns the attributed rows."""
    want = np.asarray(jx_features.descriptor_stage(jnp.asarray(patches), variant, method)).astype(np.uint8)
    assert got.dtype == np.uint8 and got.shape == want.shape == (len(patches), 64)
    np.testing.assert_array_equal(np.sort(got, axis=1), np.tile(np.arange(64, dtype=np.uint8), (len(got), 1)))
    rows = np.nonzero((got != want).any(axis=1))[0]
    if len(rows) == 0:
        return []
    pn = normalize_patches(torch.from_numpy(patches[rows])).numpy()
    port = descriptor.brief_descriptor(torch.from_numpy(pn), variant, method).numpy()
    jpn = jx_patch.normalize_patches(jnp.asarray(patches[rows]))
    jx = np.asarray(_jx_brief(jpn, variant=variant, method=method))
    v64, peak = _f64_values(patches[rows], variant, method)
    if variant == "brief":  # a bit that differs: its difference within the bound of 0
        margin = np.where(port != jx, np.abs(v64), 0.0).max(axis=1)
    else:  # two values in another order: their difference within the bound
        flipped = _order(port) != _order(jx)
        margin = np.where(flipped, np.abs(v64[:, :, None] - v64[:, None, :]), 0.0).max(axis=(1, 2))
    assert (margin <= BOUND * peak).all(), {int(r): float(m / p) for r, m, p in zip(rows, margin, peak)}
    return [int(r) for r in rows]


@pytest.mark.parametrize("variant,method", CASES)
def test_brief_plain_matches_jax_descriptor_stage(variant, method):
    patches = np.random.default_rng(40 + method).standard_normal((200, 11, 11, 11)).astype(np.float32)
    got = patch_cuda.brief_plain(torch.from_numpy(patches), variant, method).numpy()
    attributed = _hold_to_jax(got, patches, variant, method)
    print(f"{variant} method {method}: rows within the pre-blur gap {attributed}")
    assert attributed == []


@pytest.mark.parametrize("variant,method", CASES)
def test_rotated_brief_plain_matches_jax_descriptor_stage(rotated_patches, variant, method):
    rows, patches = rotated_patches
    got = patch_cuda.rotated_brief_plain(*rows, 0, None, variant, method).numpy()
    np.testing.assert_array_equal(got, patch_cuda.brief_plain(torch.from_numpy(patches), variant, method).numpy())
    attributed = _hold_to_jax(got, patches, variant, method)
    print(f"{variant} method {method}: rows within the pre-blur gap {attributed}")
    assert attributed == []


@pytest.mark.parametrize("variant", VARIANTS)
def test_f64_replay_holds_both_sides_within_the_bound(variant):
    """The replay the attribution uses: the port's and JAX's f32 values each
    within BOUND of the normalized patch's peak of it (BRIEF: the bits
    agree wherever the f64 difference is farther than that from 0)."""
    patches = np.random.default_rng(7).standard_normal((100, 11, 11, 11)).astype(np.float32)
    port = descriptor.brief_descriptor(normalize_patches(torch.from_numpy(patches)), variant, 2).numpy()
    jx = np.asarray(_jx_brief(jx_patch.normalize_patches(jnp.asarray(patches)), variant=variant, method=2))
    v64, peak = _f64_values(patches, variant, 2)
    if variant == "brief":
        clear = np.abs(v64) > BOUND * peak[:, None]
        assert clear.mean() > 0.99
        for got in (port, jx):
            np.testing.assert_array_equal(got[clear], (v64 < 0)[clear].astype(np.float32))
        return
    for got in (port, jx):
        assert (np.abs(got - v64) <= BOUND * peak[:, None]).all()


def _sort_keys(x):
    """The fused BRIEF kernel's sort_key in numpy: ints ordered by value,
    -0 equal to +0, NaN after every number and all NaNs equal."""
    b = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.int32)
    return np.where(np.isnan(x), np.iinfo(np.int32).max, np.where(b >= 0, b, b ^ 0x7FFFFFFF))


def test_kernel_rank_order_is_rank_normalize():
    """The fused kernel's rank, #{j: k_j < k_i} + #{j < i: k_j == k_i} on
    its sort keys (a stable sort's place), in numpy, against
    rank_normalize: BRIEF's 0/1 rows, -0 and +0, +-inf, NaN rows and NaN
    among numbers."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2, (40, 64)).astype(np.float32)
    x[0] = 0.0
    x[1, ::2] = -0.0
    x[2] = np.nan
    x[3, rng.integers(0, 64, 9)] = np.nan
    x[4] = rng.standard_normal(64)
    x[4, [5, 50]] = np.nan
    x[5] = rng.standard_normal(64) * 1e-30
    x[5, [1, 2, 3]] = [np.inf, -np.inf, -0.0]
    x[6] = -np.abs(rng.standard_normal(64))
    k = _sort_keys(x)
    ki, kj = k[:, :, None], k[:, None, :]
    earlier = np.arange(64)[None, :] < np.arange(64)[:, None]  # [i, j]: j < i
    counted = ((kj < ki) | ((kj == ki) & earlier)).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(descriptor.rank_normalize(torch.from_numpy(x)).numpy(), counted)


def test_pair_table_made_once_a_device():
    for method in range(5):
        flat, dist = descriptor.brief_pairs(method, torch.device("cpu"))
        assert descriptor.brief_pairs(method, torch.device("cpu"))[0] is flat
        p, q = descriptor.brief_pair_table(method)
        for t, f in zip((p, q), flat.numpy()):
            np.testing.assert_array_equal(np.stack([f % 11, f // 11 % 11, f // 121], axis=1), t)
        assert flat.dtype == torch.int32 and dist.dtype == torch.float32 and (dist >= 1).all()


def test_rows_do_not_depend_on_the_batch_or_a_slab(gstack, rotated_patches):
    """Each rotated row's descriptor is the same alone, in a batch of 7 and
    from a Z slab holding its reads (small rows near the middle of z), on
    every variant; descriptor_stage takes the fused path (brief)."""
    rows, patches = rotated_patches
    g, rest = rows[0], rows[1:]
    for variant in VARIANTS:
        whole = patch_cuda.rotated_brief(g, *rest, 0, None, variant)
        for sel in ([0], [159], list(range(5, 12))):
            assert torch.equal(patch_cuda.rotated_brief(g, *(t[sel] for t in rest), 0, None, variant), whole[sel])
        small = [t[:12].clone() for t in rest]
        small[2][:] = 2.0
        small[1][:, 2] = torch.linspace(25.0, 39.0, 12)
        z0, z1 = 14, 50
        got = patch_cuda.rotated_brief(g[:, z0:z1].contiguous(), *small, z0, DIMS[0], variant)
        assert torch.equal(got, patch_cuda.rotated_brief(g, *small, 0, None, variant))
        assert torch.equal(features.descriptor_stage(torch.from_numpy(patches), variant),
                           patch_cuda.brief_plain(torch.from_numpy(patches), variant))


@pytest.mark.parametrize("variant", ["goh", *VARIANTS])
def test_rows_land_in_a_given_out(rotated_patches, variant):
    """descriptor_stage and the fused K4 write into a caller's uint8 rows (the
    descriptors stage's one tensor, no copy on the card) the rows they
    return otherwise; a wrong `out` raises."""
    rows, patches = rotated_patches
    p = torch.from_numpy(patches[:20])
    out = torch.zeros((40, 64), dtype=torch.uint8)
    got = features.descriptor_stage(p, variant, out=out[:20])
    assert got.data_ptr() == out.data_ptr() and torch.equal(out[:20], features.descriptor_stage(p, variant))
    sel = [t[:20] for t in rows[1:]]
    if variant == "goh":
        patch_cuda.rotated_goh(rows[0], *sel, out=out[20:])
        assert torch.equal(out[20:], patch_cuda.rotated_goh(rows[0], *sel))
    else:
        patch_cuda.rotated_brief(rows[0], *sel, 0, None, variant, out=out[20:])
        assert torch.equal(out[20:], patch_cuda.rotated_brief(rows[0], *sel, 0, None, variant))
    with pytest.raises(ValueError, match="out must be"):
        features.descriptor_stage(p, variant, out=torch.zeros((20, 64), dtype=torch.int32))
