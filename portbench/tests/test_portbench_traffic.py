"""The traffic generators repeat for a fixed seed and differ across seeds."""

import numpy as np

from reference.keyparse import read_key
from traffic import keysets
from traffic.volumes import host_volumes

PARAMS = dict(count=3, rows=50, max_rot_deg=15, scale_lo=0.9, scale_hi=1.1, max_shift=10, loc_noise=0.7,
              scale_noise=0.05, ori_noise=0.05, desc_noise=0.8, replaced=1 / 3)


def test_volumes_repeat_for_a_seed():
    a = host_volumes((12, 14, 10), 2**31 + 5, 3, 20, "cpu")
    b = host_volumes((12, 14, 10), 2**31 + 5, 3, 20, "cpu")
    c = host_volumes((12, 14, 10), 2**31 + 6, 3, 20, "cpu")
    assert all(x.dtype == np.float32 and x.shape == (12, 14, 10) and x.flags.writeable for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])  # distinct subjects within a run
    assert not np.array_equal(a[0], c[0])


def test_key_sets_repeat_for_a_seed(tmp_path):
    a = keysets.group(3_000_000_001, PARAMS, (182, 218, 182), 6)
    b = keysets.group(3_000_000_001, PARAMS, (182, 218, 182), 6)
    c = keysets.group(3_000_000_002, PARAMS, (182, 218, 182), 6)
    assert [keysets.key_text(s) for s in a] == [keysets.key_text(s) for s in b]
    assert keysets.key_text(a[1]) != keysets.key_text(c[1])
    paths = keysets.write_group(a, str(tmp_path))
    base = read_key(paths[0])
    assert base["xyz"].shape == (50, 3) and base["desc"].shape == (50, 64)
    assert (base["info"] & keysets.INFO_REORIENT).all()
    assert (np.sort(base["desc"], axis=1) == np.arange(64)).all()  # ranks 0..63
    lo = np.zeros(3)
    hi = np.array([182, 218, 182][::-1], float)
    assert ((base["xyz"] >= lo) & (base["xyz"] <= hi)).all()


def test_key_text_reads_back_the_same_through_the_port(tmp_path):
    from sift3d_torch.io import keyfile

    paths = keysets.write_group(keysets.group(7, PARAMS, (182, 218, 182), 6), str(tmp_path))
    for p in paths:
        mine = read_key(p)
        port, _ = keyfile.read_text(p)
        for k in ("xyz", "scale", "ori", "eigs", "info", "desc"):
            assert np.array_equal(np.asarray(getattr(port, k)).view(np.uint8), np.asarray(mine[k]).view(np.uint8)), k
