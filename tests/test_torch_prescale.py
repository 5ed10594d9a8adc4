"""PyTorch port: featExtract's -2+ on the extraction entry points
(``prescale``), the sub-batch planner, and the batched upsample.

On the CPU (32^3 volumes doubled to 64^3):
- the planner keeps a 1 mm cohort of 32 whole at an 80 GB budget, splits a
  doubled one into balanced sub-batches, and always gives the fewest
  sub-batches that fit;
- ``extract_features_many(..., prescale="double")`` split into two
  sub-batches equals the unsplit call and each volume's
  ``extract_features(..., prescale="double")``, bit for bit;
- the pipeline's "double" equals the CLI's old sequence (double the
  volume, the pipeline's body at initial image scale 0.5, halve location
  and scale), bit for bit.
On the card (``cuda``): ``csrc/double_size.cu`` equals the plain
``double_size`` chain on odd, even and length-1 axes and on a batch.
"""

import math

import numpy as np
import pytest
import torch

from sift3d_torch.core.config import SiftConfig
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.kernels import resample_cuda
from sift3d_torch.kernels.cuda_lib import launches
from sift3d_torch.kernels.resample import double_size
from sift3d_torch.pipeline import extract
from sift3d_torch.pipeline.extract import extract_features, extract_features_many
from sift3d_torch.utils.synthetic import synthetic_volume
from sift3d_torch.utils.timing import TRACER

torch.set_num_threads(1)
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
T1 = (182, 218, 182)
T1_X2 = (364, 436, 364)


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in FIELDS)


@pytest.fixture(scope="module")
def volumes():
    # every other voxel of a 64^3 volume: its blobs, doubled back, are large
    # enough to detect (test_torch_cli_flags.py's cube32)
    return [np.ascontiguousarray(synthetic_volume(64, seed=s)[::2, ::2, ::2]) for s in (3, 5, 7)]


def test_a_1mm_cohort_of_32_is_one_subbatch_at_80_gb():
    assert extract.plan_subbatches(T1, 32, 80e9) == [32]


def test_a_doubled_cohort_of_32_splits_into_balanced_subbatches():
    sizes = extract.plan_subbatches(T1_X2, 32, 80e9)
    assert len(sizes) > 1 and sum(sizes) == 32 and max(sizes) - min(sizes) <= 1
    assert max(sizes) * extract.volume_bytes(T1_X2) <= 80e9


@pytest.mark.parametrize("n, budget_volumes", [(32, 16.5), (32, 11), (7, 3), (5, 100), (3, 0.5), (1, 1)])
def test_the_plan_is_the_fewest_balanced_subbatches_that_fit(n, budget_volumes):
    per = extract.volume_bytes(T1_X2)
    budget = int(budget_volumes * per)
    sizes = extract.plan_subbatches(T1_X2, n, budget)
    fit = max(1, min(n, int(budget_volumes)))
    assert sum(sizes) == n and max(sizes) - min(sizes) <= 1 and sorted(sizes, reverse=True) == sizes
    assert max(sizes) <= fit
    assert len(sizes) == math.ceil(n / fit)


def test_the_plan_without_a_budget_and_of_nothing():
    assert extract.plan_subbatches(T1_X2, 32, None) == [32]
    assert extract.plan_subbatches(T1_X2, 0, 80e9) == []
    assert extract.device_budget(torch.device("cpu")) is None


def test_the_estimate_counts_the_octave0_peak():
    # batch 1, levels 6, stack 6, DoGs 5, int8 mask 3/4, next base 1/8
    assert extract.volume_bytes(T1) == math.ceil(18.875 * 4 * math.prod(T1))
    assert extract.extraction_shape(T1, "double") == T1_X2
    assert extract.extraction_shape((5, 1, 4), "double") == (10, 1, 8)
    assert extract.extraction_shape((5, 6, 4)) == (5, 6, 4)


def test_a_split_doubled_cohort_equals_the_unsplit_call_and_each_volume_alone(volumes, monkeypatch):
    alone = [extract_features(v, device="cpu", prescale="double") for v in volumes]
    whole = extract_features_many(volumes, device="cpu", prescale="double")
    # room for two doubled volumes: sub-batches of 2 and 1
    per = extract.volume_bytes(extract.extraction_shape(volumes[0].shape, "double"))
    monkeypatch.setattr(extract, "device_budget", lambda dev: 2 * per + 1)
    assert extract.plan_subbatches((64, 64, 64), 3, 2 * per + 1) == [2, 1]
    with TRACER.record():
        split = extract_features_many(volumes, device="cpu", prescale="double")
    assert TRACER.counts["subbatches"] == 2
    assert TRACER.counts["upsampled_bytes"] == 3 * 4 * 64**3
    # one input span a sub-batch, which the benchmark counts
    assert [s.name for s in TRACER.spans].count("input") == 2
    assert [s.name for s in TRACER.spans].count("upsample") == 2
    assert all(len(f) > 0 for f in alone)
    for a, w, s in zip(alone, whole, split):
        assert _same(a, w) and _same(a, s)


@pytest.mark.parametrize("prescale", ["double"])
def test_prescale_equals_the_clis_old_sequence(prescale):
    # a 32^3 volume, extracted at 64^3: the pipeline's body on the doubled
    # volume at initial image scale 0.5, then halved
    vol = np.ascontiguousarray(synthetic_volume(64, seed=7)[::2, ::2, ::2])
    doubled = double_size(torch.from_numpy(vol.copy()))[None]
    want = FeatureSet.concatenate([
        extract.octave_features(rows, octave)
        for octave, rows in extract._batch_octaves(doubled, SiftConfig(), TRACER, 0.5, "goh", None, False)
    ])
    want.xyz *= 0.5
    want.scale *= 0.5
    got = extract_features(vol, device="cpu", prescale=prescale)
    assert len(want) > 0 and _same(got, want)
    assert _same(extract_features_many([vol], device="cpu", prescale=prescale)[0], want)


def test_unknown_prescale_is_refused(volumes):
    with pytest.raises(ValueError, match="prescale"):
        extract_features_many(volumes, device="cpu", prescale="twice")
    # -2- halves in the CLI, not in the pipeline
    with pytest.raises(ValueError, match="prescale"):
        extract_features(volumes[0], device="cpu", prescale="halve")


def test_the_plain_batch_route_doubles_volume_by_volume():
    rng = np.random.default_rng(3)
    for shape in ((3, 5, 4), (1, 4, 3), (4, 1, 5), (2, 3, 1), (1, 1, 1)):
        batch = torch.from_numpy(rng.standard_normal((2,) + shape).astype(np.float32))
        out = torch.empty((2,) + resample_cuda.doubled_shape(shape))
        resample_cuda.double_size_batch(batch, out)
        for b in range(2):
            assert torch.equal(out[b], double_size(batch[b])), shape
    with pytest.raises(ValueError):
        resample_cuda.double_size_batch(batch, torch.empty((2, 3, 3, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7, 9), (6, 8, 10), (1, 7, 9), (5, 1, 9), (5, 7, 1), (1, 1, 1),
                                   (3, 37, 75), (4, 91, 109, 91)])
def test_the_upsample_kernel_equals_the_plain_chain_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    shape = shape if len(shape) == 4 else (1,) + shape
    rng = np.random.default_rng(sum(shape))
    batch = torch.from_numpy((100 * rng.standard_normal(shape)).astype(np.float32))
    out = torch.full((shape[0],) + resample_cuda.doubled_shape(shape[1:]), float("nan"), device=dev)
    before = launches("sift3d_double_size")
    resample_cuda.double_size_batch(batch.to(dev), out)
    torch.cuda.synchronize()
    assert launches("sift3d_double_size") == before + 1
    for b in range(shape[0]):
        assert torch.equal(out[b].cpu(), double_size(batch[b])), (shape, b)
