"""PyTorch port: the Z-sharded pieces against the JAX package's on the
conftest's 8-device CPU mesh, and against the port's own whole-volume
functions, at sizes where the halo is deeper than a shard (multi-hop).

- the sharded blur (K7's plain form on halo-extended shards) equals the
  port's whole-volume blur bit for bit, and the JAX sharded blur within
  1e-6 of the peak (XLA's einsum sums in another order);
- the sharded extrema mask equals JAX's _extrema_sharded exactly;
- the samplers on a Z slab with its origin equal them on the whole volume;
- the sharded pyramid's gathered stacks and masks equal the single-device
  octave bit for bit.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sift3d.dist import halo as jx_halo
from sift3d.dist import mesh as jx_mesh
from sift3d.dist import spatial as jx_spatial
from sift3d_torch.core.config import SiftConfig
from sift3d_torch.dist import halo, spatial
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.kernels import extrema, gauss, patch_cuda
from sift3d_torch.pipeline import pyramid

torch.set_num_threads(1)
CFG = SiftConfig()
MESH = make_mesh(8, ["cpu"])


@pytest.fixture(scope="module")
def jx_space():
    assert len(jax.devices()) == 8, "conftest must simulate 8 CPU devices"
    return jx_mesh.make_mesh(batch=1, space=8)


def _texture(rng, shape, sigma=1.8):
    v = rng.standard_normal(shape).astype(np.float32)
    return (ndi.gaussian_filter(v, sigma) * 120).astype(np.float32)


def test_make_mesh_cycles_and_needs_a_card_by_default(monkeypatch):
    assert make_mesh(3, ["cpu"]) == [torch.device("cpu")] * 3
    assert make_mesh(4, ["cpu", "meta"]) == [torch.device(d) for d in ("cpu", "meta", "cpu", "meta")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)


@pytest.mark.parametrize("radius", [1, 3, 7])
def test_exchange_halo_relays_over_shards(radius):
    vol = torch.arange(16 * 2 * 3, dtype=torch.float32).reshape(16, 2, 3) + 1
    ext = halo.exchange_halo_z(halo.shard_volume(vol, MESH), radius)
    padded = torch.cat([torch.zeros(radius, 2, 3), vol, torch.zeros(radius, 2, 3)])
    for i, e in enumerate(ext):
        assert torch.equal(e, padded[2 * i : 2 * i + 2 + 2 * radius])


@pytest.mark.parametrize("sigma", [1.5199, 3.0897])
def test_blur_sharded_matches_whole_volume_and_jax(rng, jx_space, sigma):
    vol = _texture(rng, (16, 14, 12))  # tz = 2 < radius 4..8
    got = torch.cat(halo.blur3d_sharded(halo.shard_volume(torch.from_numpy(vol), MESH), sigma, 0.01))
    whole = gauss.blur3d(torch.from_numpy(vol), sigma, 0.01)
    assert torch.equal(got, whole)
    want = jx_halo.blur3d_sharded(jx_halo.shard_volume(jnp.asarray(vol), jx_space), sigma, jx_space, 0.01)
    peak = float(np.abs(vol).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * peak)


def test_extrema_sharded_matches_jax(rng, jx_space):
    # Z padded from 13 to 16: the global border rule zeroes row 12 and beyond
    true_z = 13
    dogs = _texture(rng, (5, 16, 20, 24), 1.5)
    dogs[:, true_z:] = 0.0
    want = jx_spatial._extrema_sharded(
        jax.device_put(jnp.asarray(dogs), NamedSharding(jx_space, P(None, "space", None, None))),
        jx_space, true_z=true_z,
    )
    shards = halo.shard_volume(torch.from_numpy(dogs), MESH)
    got = torch.cat(spatial._extrema_sharded(shards, true_z), dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != 0).sum() > 0


@pytest.mark.parametrize("true_z", [16, 13])
def test_extrema_sharded_equals_whole_volume(rng, true_z):
    dogs = _texture(rng, (5, 16, 20, 24), 1.5)
    dogs[:, true_z:] = 0.0
    got = torch.cat(spatial._extrema_sharded(halo.shard_volume(torch.from_numpy(dogs), MESH), true_z), dim=1)
    want = extrema.extrema_mask(torch.from_numpy(dogs[:, :true_z]))
    assert torch.equal(got[:, :true_z], want) and not got[:, true_z:].any()


def test_samplers_on_a_slab_equal_the_whole_volume(rng):
    g = torch.from_numpy(_texture(rng, (6, 40, 18, 16)))
    r = 40
    lvl = torch.from_numpy(rng.integers(0, 6, r).astype(np.int32))
    centers = torch.from_numpy(rng.uniform([2, 2, 12], [14, 16, 28], (r, 3)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(0.8, 2.0, r).astype(np.float32))
    oris, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((r, 3, 3)).astype(np.float32)))
    z0, z1 = 5, 35  # every read of these rows lies in [z0, z1)
    slab = g[:, z0:z1].contiguous()
    assert torch.equal(
        patch_cuda.sample_identity_plain(slab, lvl, centers, scales, z0, 40),
        patch_cuda.sample_identity_plain(g, lvl, centers, scales),
    )
    assert torch.equal(
        patch_cuda.sample_rotated(slab, lvl, centers, scales, oris.contiguous(), z0, 40),
        patch_cuda.sample_rotated(g, lvl, centers, scales, oris.contiguous()),
    )
    with pytest.raises(ValueError, match="does not fit"):
        patch_cuda._slab_args(slab, 20, 40)


@pytest.mark.parametrize("shape, true_z", [((64, 20, 18), 64), ((64, 20, 18), 59)])
def test_sharded_octave_equals_single_device(rng, shape, true_z):
    vol = _texture(rng, shape)
    vol[true_z:] = 0.0
    base = spatial.initial_blur_spatial(halo.shard_volume(torch.from_numpy(vol), MESH), CFG, true_z)
    want_base = pyramid.initial_blur_core(torch.from_numpy(vol[:true_z]), CFG)
    assert torch.equal(torch.cat(base)[:true_z], want_base)
    assert not torch.cat(base)[true_z:].any()
    octv = spatial.octave_step_spatial(base, CFG, true_z)
    gstack, _, mask, next_base = pyramid.octave_core(want_base, CFG)
    assert torch.equal(halo.planes(octv.gstack, 0, true_z, "cpu"), gstack)
    assert torch.equal(halo.planes(octv.mask, 0, true_z, "cpu"), mask)
    assert torch.equal(halo.planes(octv.next_base, 0, true_z // 2, "cpu"), next_base)
    assert (mask != 0).sum() > 0
