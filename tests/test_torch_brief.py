"""PyTorch port: the BRIEF family (-b/-br/-bn) against the JAX package.

- The frozen pair tables of methods 0-4 are equal, directly and through
  from_numpy_state's static tables.
- brief_descriptor on the same patches: RRIEF within 2e-7 of each patch's
  peak. The pre-blur is where the two differ: the compiled JAX
  blur3d_batched sums its einsums in XLA's order, about one ulp off the
  port's ascending fma chain on 68% of values (tests/test_torch_blur.py).
  BRIEF (the sign of d) and NRRIEF (d over an integer distance) are then
  equal wherever |d| exceeds that bound.
- descriptor_stage: the rank-normalized uint8 rows JAX's stage gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.kernels import descriptor as jx_descriptor
from sift3d.pipeline import features as jx_features
from sift3d_torch.core.config import from_numpy_state, static_table
from sift3d_torch.kernels import descriptor
from sift3d_torch.pipeline import features

torch.set_num_threads(1)
BOUND = 2e-7  # of the patch's peak |value|

_jx_brief = jax.jit(jx_descriptor.brief_descriptor, static_argnames=("variant", "method", "blur_sigma"))


def _patches(n=300, seed=11):
    return np.random.default_rng(seed).standard_normal((n, 11, 11, 11)).astype(np.float32)


@pytest.mark.parametrize("method", range(5))
def test_pair_tables_equal_jax(method):
    p, q = descriptor.brief_pair_table(method)
    jp, jq = jx_descriptor.brief_pair_table(method)
    for got, want in ((p, jp), (q, jq)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not p.flags.writeable and not q.flags.writeable


def test_pair_tables_through_from_numpy_state():
    cfg = JxConfig()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    tables = {f"brief_pairs/{m}": np.stack(jx_descriptor.brief_pair_table(m)) for m in range(5)}
    tables["taps/brief"] = jx_descriptor.gauss.gaussian_kernel_1d(cfg.brief_blur_sigma, 0.01)
    port_cfg = from_numpy_state(fields, tables)
    assert (port_cfg.brief_blur_sigma, port_cfg.brief_method) == (0.95, 2)
    for name, want in tables.items():
        assert np.array_equal(static_table(name, port_cfg), want), name
    bad = tables["brief_pairs/3"].copy()
    bad[1, 0, 0] += 1
    with pytest.raises(ValueError, match="brief_pairs/3"):
        from_numpy_state(fields, dict(tables, **{"brief_pairs/3": bad}))
    # the port's blur is always full f32: "highest" is accepted, "high" is not
    assert from_numpy_state(dict(fields, blur_matmul_precision="highest"), {}) == port_cfg
    with pytest.raises(ValueError, match="blur_matmul_precision"):
        from_numpy_state(dict(fields, blur_matmul_precision="high"), {})


@pytest.mark.parametrize("method", [2, 3])
def test_brief_descriptor_matches_jax(method):
    patches = _patches()
    peak = np.abs(patches).reshape(len(patches), -1).max(axis=1)[:, None]
    x = torch.from_numpy(patches)
    d_port = descriptor.brief_descriptor(x, "rrief", method).numpy()
    d_jax = np.asarray(_jx_brief(jnp.asarray(patches), variant="rrief", method=method))
    err = np.abs(d_port - d_jax) / peak
    print(f"method {method}: RRIEF max |diff| / peak {err.max():.3g}, differing {(d_port != d_jax).mean():.3f}")
    assert (err <= BOUND).all()
    clear = np.abs(d_jax) > BOUND * peak
    assert clear.mean() > 0.99
    brief = descriptor.brief_descriptor(x, "brief", method).numpy()
    want = np.asarray(_jx_brief(jnp.asarray(patches), variant="brief", method=method))
    np.testing.assert_array_equal(brief[clear], want[clear])
    np.testing.assert_array_equal(brief, (d_port < 0).astype(np.float32))
    # NRRIEF: d over max(int(|p - q|), 1), the same quotient on both sides
    p, q = descriptor.brief_pair_table(method)
    dist = np.maximum(np.sqrt(((p - q) ** 2).sum(axis=1)).astype(np.int32), 1).astype(np.float32)
    nrrief = descriptor.brief_descriptor(x, "nrrief", method).numpy()
    want = np.asarray(_jx_brief(jnp.asarray(patches), variant="nrrief", method=method))
    np.testing.assert_array_equal(nrrief, d_port / dist)
    np.testing.assert_array_equal(np.sign(nrrief[clear]), np.sign(want[clear]))
    assert (np.abs(nrrief - want) / peak <= BOUND).all()
    with pytest.raises(ValueError, match="variant"):
        descriptor.brief_descriptor(x, "orb", method)


@pytest.mark.parametrize("variant", ["goh", "brief", "rrief", "nrrief"])
def test_descriptor_stage_matches_jax(variant):
    """The stage's uint8 ranks, on patches far from a tie."""
    patches = _patches(64, seed=12)
    got = features.descriptor_stage(torch.from_numpy(patches), variant).numpy()
    want = np.asarray(jx_features.descriptor_stage(jnp.asarray(patches), variant)).astype(np.uint8)
    assert got.dtype == np.uint8 and got.shape == (64, 64)
    np.testing.assert_array_equal(np.sort(got, axis=1), np.tile(np.arange(64, dtype=np.uint8), (64, 1)))
    same = (got == want).all(axis=1).mean()
    print(f"{variant}: identical rows {same:.3f}")
    assert same >= 0.99
