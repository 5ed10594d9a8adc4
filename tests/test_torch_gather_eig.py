"""PyTorch port: the fused K2 (features.gather_eig: refinement, identity
patch, normalization, structure tensor, eigen test) on the CPU, where it runs
its plain version gather_eig_plain, against the JAX package's gather_stage
and eig_stage on the same octave; its rows independent of the batch and of a
Z slab; and numerics.tree_sum, the fixed order the kernel sums in, against a
numpy model of its pairing.

Tolerances: the refinement (locations, scales, the bounds test) equals the
JAX package's bit for bit; the patches agree within 1e-5 of the stack's peak
(test_torch_patch.py: XLA contracts the boxed sampler's weights in its own
order, ROADMAP Queue 3); the eigen test is held on the same patches at
test_torch_patch.py's tolerances (pn and eigenvalues rtol 1e-5, orientations
atol 1e-5, keep equal) on every row an f64 replay finds well conditioned.
The replay computes each row's structure tensor and eigenvalues in float64;
a row is ill conditioned when its largest eigenvalue over the smaller gap
between neighbouring eigenvalues exceeds 32. On those rows, named in
ILL_CONDITIONED and in ROADMAP Queue 3, the two f32 closed-form solvers
(XLA's with glibc cosf, rsqrt and fused multiply-adds; the port's) miss the
f64 eigenvalues by up to 1.1e-4 relative and round the vectors apart by up
to 2.6e-4 on the rows in bounds, so they are held, where in bounds, to 1e-5 of the row's
largest eigenvalue and to orientations within 1e-3 (the e2e test's); the
pipeline drops the rows out of bounds. The keep rule is equal on every row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.kernels import patch as jx_patch
from sift3d.pipeline import features as jx_features
from sift3d_torch.core.config import SiftConfig
from sift3d_torch.core.numerics import tree_sum
from sift3d_torch.kernels import extrema_cuda
from sift3d_torch.kernels.patch_cuda import sample_identity_plain
from sift3d_torch.pipeline import features, pyramid
from sift3d_torch.utils.synthetic import synthetic_blob_texture

torch.set_num_threads(1)
CFG = SiftConfig()
SIGMAS = tuple(CFG.level_sigmas())
CELLS = {"48x56x64_s3": ((48, 56, 64), 3), "64^3_s5": ((64, 64, 64), 5)}
KAPPA_MAX = 32.0
# candidate rows of each cell whose f64 replay gives kappa > KAPPA_MAX
ILL_CONDITIONED = {
    "48x56x64_s3": [0, 1, 3, 6, 7, 8, 11, 13, 20],
    "64^3_s5": [1, 2, 4, 7, 9, 12, 13, 15, 18, 19, 22, 28],
}


def _octave(dims, seed):
    vol = torch.from_numpy(synthetic_blob_texture(dims, seed=seed, n_blobs=30))
    gstack, _, _, _ = pyramid.octave_core(pyramid.initial_blur_core(vol, CFG), CFG)
    gstack = gstack.contiguous()
    dogs, mask = extrema_cuda.dogs_extrema_plain(gstack)
    lvl, zyx, _ = features.candidate_table(mask)
    return gstack, dogs, lvl, zyx


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_gather_eig_matches_jax(cell):
    gstack, dogs, lvl, zyx = _octave(*CELLS[cell])
    xyz, scale, inb, pn, eigs, ori, keep = (
        t.numpy() for t in features.gather_eig(gstack, dogs, lvl, zyx, SIGMAS, CFG)
    )
    j_xyz, j_scale, j_inb, j_patches = (np.asarray(t) for t in jx_features.gather_stage(
        jnp.asarray(gstack.numpy()), jnp.asarray(dogs.numpy()), jnp.asarray(lvl.numpy().astype(np.int32)),
        jnp.asarray(zyx.numpy().astype(np.int32)), jnp.ones(lvl.shape[0], bool), SIGMAS,
    ))
    np.testing.assert_array_equal(xyz, j_xyz)
    np.testing.assert_array_equal(scale, j_scale)
    np.testing.assert_array_equal(inb, j_inb)
    assert 0 < inb.sum() < len(inb)
    # the JAX boxed sampler is exact for in-bounds rows only
    patches = sample_identity_plain(gstack, lvl.to(torch.int32), torch.from_numpy(xyz), torch.from_numpy(scale))
    np.testing.assert_allclose(patches.numpy()[inb], j_patches[inb], rtol=0,
                               atol=1e-5 * float(gstack.abs().max()))
    j_keep = np.asarray(jx_features.eig_stage(jnp.asarray(j_patches), JxConfig())[3])
    np.testing.assert_array_equal(keep[inb], j_keep[inb])
    # the eigen test on the same patches, on every row; pn on the rows in
    # bounds, as test_torch_patch.py's (a row out of bounds saturates into a
    # nearly flat patch, whose mean cancels most of each value)
    j_pn, j_eigs, j_ori, j_keep = (
        np.asarray(t) for t in jx_features.eig_stage(jnp.asarray(patches.numpy()), JxConfig())
    )
    np.testing.assert_allclose(pn[inb], j_pn[inb], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(keep, j_keep)
    kappa = _f64_kappa(j_pn)
    ill = kappa > KAPPA_MAX
    assert np.nonzero(ill)[0].tolist() == ILL_CONDITIONED[cell]
    well = ~ill
    assert well.sum() >= 15 and (well & inb).any()
    np.testing.assert_allclose(eigs[well], j_eigs[well], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ori[well], j_ori[well], rtol=0, atol=1e-5)
    held = ill & inb  # the pipeline drops the rows out of bounds
    big = np.abs(j_eigs[held]).max(axis=1, keepdims=True)
    assert (np.abs(eigs[held] - j_eigs[held]) <= 1e-5 * big).all()
    np.testing.assert_allclose(ori[held], j_ori[held], rtol=0, atol=1e-3)


def _f64_kappa(pn):
    """The f64 replay: each row's sphere-masked structure tensor of the
    normalized patch pn [C, 11, 11, 11] (central differences, zero border)
    and its eigenvalues in float64; returns the largest eigenvalue over the
    smaller gap between neighbouring eigenvalues."""
    p = pn.astype(np.float64)
    g = np.zeros((3,) + p.shape)
    c = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    g[0][c] = p[:, 1:-1, 1:-1, 2:] - p[:, 1:-1, 1:-1, :-2]
    g[1][c] = p[:, 1:-1, 2:, 1:-1] - p[:, 1:-1, :-2, 1:-1]
    g[2][c] = p[:, 2:, 1:-1, 1:-1] - p[:, :-2, 1:-1, 1:-1]
    f = (g * jx_patch.sphere_mask()).reshape(3, p.shape[0], -1)
    lam = np.linalg.eigvalsh(np.einsum("icp,jcp->cij", f, f))  # ascending
    return lam[:, 2] / np.minimum(lam[:, 2] - lam[:, 1], lam[:, 1] - lam[:, 0])


def _same_rows(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_rows_do_not_depend_on_the_batch_or_a_slab():
    """Each row's outputs are bit-identical alone, in a batch of 7, in the
    whole table, and from a Z slab of the octave: every reduction sums in
    tree_sum's order, whatever the row count (the repair of the orientation
    fault between card and CPU, and between --spatial and one device)."""
    gstack, dogs, lvl, zyx = _octave((64, 64, 64), 5)
    whole = features.gather_eig(gstack, dogs, lvl, zyx, SIGMAS, CFG)
    n = lvl.shape[0]
    assert n >= 14
    for rows in ([0], [n - 1], list(range(3, 10)), list(range(n - 7, n))):
        part = features.gather_eig(gstack, dogs, lvl[rows], zyx[rows], SIGMAS, CFG)
        assert _same_rows(part, (t[rows] for t in whole)), rows
    # a slab whose planes hold every read of the chosen rows
    z0, z1 = 10, 54
    xyz, scale = whole[0], whole[1]
    reach = 2.0 * scale + 2.0
    sel = (xyz[:, 2] - reach >= z0) & (xyz[:, 2] + reach < z1) & (zyx[:, 0] - 1 >= z0) & (zyx[:, 0] + 1 < z1)
    sel = torch.nonzero(sel)[:, 0]
    assert sel.shape[0] >= 5
    slab = features.gather_eig(
        gstack[:, z0:z1].contiguous(), dogs[:, z0:z1].contiguous(), lvl[sel], zyx[sel], SIGMAS,
        CFG, gz0=z0, dz0=z0, depth=64,
    )
    assert _same_rows(slab, (t[sel] for t in whole))


def _tree_model(x):
    """numpy model of tree_sum's pairing: pad to a power of two with zeros,
    then add element i + h to element i until one is left, in float32."""
    a = [np.float32(v) for v in x]
    while len(a) & (len(a) - 1):
        a.append(np.float32(0.0))
    while len(a) > 1:
        h = len(a) // 2
        a = [np.float32(a[i] + a[i + h]) for i in range(h)]
    return a[0]


@pytest.mark.parametrize("n", [1, 2, 3, 64, 100, 1331, 2048])
def test_tree_sum_pairing(rng, n):
    x = (rng.standard_normal((3, n)) * 10.0 ** rng.integers(-3, 4, (3, n))).astype(np.float32)
    got = tree_sum(torch.from_numpy(x)).numpy()
    want = np.array([_tree_model(row) for row in x], np.float32)
    np.testing.assert_array_equal(got, want)

