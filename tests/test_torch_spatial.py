"""PyTorch port: Z-sharded extraction (extract_features_spatial) against
the port's own single-device extraction, on the CPU with every shard on
one device (the counterpart of the JAX tests' 8 simulated devices).

Every coordinate stays global (the samplers take the slab's origin) and
every reduction of the feature stage sums in one fixed order whatever the
row count (numerics.tree_sum), so the rows are the single-device rows bit
for bit: counts, locations, scales, flags, orientations, eigenvalues and
descriptors. The cases cover Z padding, halos deeper than
a shard (relayed over several), the single-device tail, an unpadded Z,
-2+ (prescale "double"), a BRIEF descriptor and both fallbacks.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.dist import spatial
from sift3d_torch.dist.mesh import make_mesh
from sift3d_torch.pipeline.extract import extract_features, extract_octaves

torch.set_num_threads(1)
CFG = SiftConfig()


def _blob_volume(seed, shape):
    """tests/test_spatial_extract.py's fixture: smoothed noise."""
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (ndi.gaussian_filter(v, 1.8) * 120).astype(np.float32)


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(got.info, want.info)
    np.testing.assert_array_equal(got.ori, want.ori)
    np.testing.assert_array_equal(got.eigs, want.eigs)
    np.testing.assert_array_equal(got.desc, want.desc)


CASES = {
    # Z 70 pads to 96 over 8 shards: tz 12 and 6 against a 31-plane halo,
    # then the single-device tail
    "padded_multihop_tail": dict(seed=2, shape=(70, 44, 36), shards=8, octaves=2),
    # every octave sharded (99 clamps to the pyramid's 4)
    "all_octaves": dict(seed=1, shape=(64, 32, 32), shards=8, octaves=99),
    # 64 = 4 shards x 2^2: no padding
    "unpadded": dict(seed=3, shape=(64, 32, 32), shards=4, octaves=2),
    # -2+: the volume doubled to a 70x44x36 grid, its initial blur from
    # sigma_init / 0.5, the rows in the input's voxels
    "doubled_scale": dict(seed=2, shape=(35, 22, 18), shards=4, octaves=1, prescale="double"),
    "nrrief": dict(seed=3, shape=(70, 44, 36), shards=3, octaves=2, descriptor="nrrief"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spatial_equals_single_device(case):
    c = dict(CASES[case])
    vol = _blob_volume(c.pop("seed"), c.pop("shape"))
    mesh = make_mesh(c.pop("shards"), ["cpu"])
    kw = dict(prescale=c.get("prescale"), descriptor=c.get("descriptor", "goh"))
    want = extract_features(vol, CFG, device="cpu", **kw)
    got = spatial.extract_features_spatial(vol, mesh, CFG, sharded_octaves=c["octaves"], **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("shards, octaves", [(8, None), (1, 2)])
def test_spatial_falls_back_to_one_device(monkeypatch, shards, octaves):
    """No sharded octave (a small volume under the 2 GiB rule) or a
    one-device mesh: extract_features on mesh[0], nothing sharded."""
    def no_shards(*args, **kwargs):
        raise AssertionError("nothing should be sharded")

    monkeypatch.setattr(spatial, "shard_volume", no_shards)
    vol = _blob_volume(3, (48, 40, 40))
    got = spatial.extract_features_spatial(vol, make_mesh(shards, ["cpu"]), CFG, sharded_octaves=octaves)
    _assert_same(got, extract_features(vol, CFG, device="cpu"))


def test_auto_rule_shards_the_octaves_over_2_gib():
    # 11 f32 volumes: the doubled T1 grid (2.54 GB) shards octave 0 only
    assert spatial.sharded_octave_count((364, 436, 364), CFG) == 1
    assert spatial.sharded_octave_count((182, 218, 182), CFG) == 0
    assert spatial.sharded_octave_count((728, 872, 728), CFG) == 2
    assert spatial.sharded_octave_count((64, 64, 64), CFG, 99) == 5
    assert spatial.sampling_halo(CFG) == 31


def test_debug_gstacks_cover_every_octave():
    vol = _blob_volume(2, (70, 44, 36))
    seen, want = {}, {}
    spatial.extract_features_spatial(
        vol, make_mesh(4, ["cpu"]), CFG, sharded_octaves=2,
        on_gstack=lambda o, g: seen.setdefault(o, g.clone()),
    )
    for _ in extract_octaves(vol, CFG, "cpu", on_gstack=lambda o, g: want.setdefault(o, g.clone())):
        pass
    assert sorted(seen) == sorted(want) == list(range(4))
    for o in want:
        assert torch.equal(seen[o], want[o]), o


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means the card, for a numpy array and a CPU tensor
    alike; without one every entry point raises (the CPU runs only when
    asked for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = _blob_volume(2, (24, 24, 24))
    for img in (vol, torch.from_numpy(vol)):
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_features(img)
        with pytest.raises(RuntimeError, match="CUDA"):
            next(extract_octaves(img))
        with pytest.raises(RuntimeError, match="CUDA"):
            spatial.extract_features_spatial(img)
    assert len(extract_features(vol, device="cpu")) >= 0
