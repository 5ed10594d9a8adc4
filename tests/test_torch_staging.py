"""PyTorch port: the input path, host volumes into the batch through the
staging ring (``sift3d_torch.pipeline.staging``).

- On the CPU the ring runs with unpinned slots and a CPU destination: its
  chunk walk gives the bits of ``np.array(img, np.float32)`` for f32, f64,
  int16, uint8 and big-endian int16 arrays, read-only, F-ordered, strided
  and reversed ones (torch copies a batch's arrays where it can view them,
  numpy a single volume's and the rest, and ``shared_copy(k)``'s route
  numpy on k threads at k = 1 and 3), volumes smaller than a chunk, an
  exact multiple of it and neither, chunks shorter than k and no multiple
  of it, more volumes than slots, CPU tensors, and host threads staging
  through one ring at once, on the ring's own routes and on the shared one.
- ``extract_features_many`` on mixed shapes with numpy and CPU-tensor
  inputs keeps its order and bits, on its plain path and with its inputs
  sent through a CPU ring; a volume that is not [Z, Y, X] raises before
  any upload.
- ``Tracer.count``: nothing outside ``record()``, summed inside it (from
  threads too) and printed by ``summary()``.
- On a CUDA card (marker ``cuda``; no JAX, so ``--noconftest`` runs it):
  the staged batch equals ``_volume``'s upload bit for bit for every dtype
  and layout above; ``extract_features_many`` on 32 T1-sized volumes gives
  the FeatureSets of the same volumes uploaded as before; a profiler trace
  of a staged call holds no pageable HtoD copy and no synchronize inside
  ``input``; two threads staging to two cards (or one) give the bits; four
  threads on the shared route onto cuda:0-3 and onto cuda:0 alone give the
  bits, and placement there the FeatureSets of ``extract_features_many``
  per group; ``featextract --time`` on a NIfTI volume (the reader's
  read-only f32 array) prints the ring's counters (``shared_copy_volumes``
  0) and writes the CPU's ``.key`` bytes.
"""

import contextlib
import json
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from sift3d_torch.pipeline import extract, staging
from sift3d_torch.pipeline.extract import extract_features, extract_features_many
from sift3d_torch.pipeline.staging import StagingRing
from sift3d_torch.utils import timing
from sift3d_torch.utils.synthetic import MNI_T1_DIMS, synthetic_blob_texture, synthetic_volume
from sift3d_torch.utils.timing import TRACER, Tracer

torch.set_num_threads(1)
FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
CHUNK = 60  # elements a slot in the CPU tests
SIZES = {"under_a_chunk": (2, 3, 7), "chunk_multiple": (3, 4, 15), "ragged": (5, 7, 11)}  # 42, 180, 385


def _array(shape, dtype, layout, rng):
    """A host volume of `shape` and `dtype` laid out as `layout`."""
    base = rng.uniform(-300, 300, (shape[0] * 2, shape[1], shape[2] * 2))
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        base = np.clip(np.round(base), info.min, info.max)
    elif dtype == np.float64:
        base = base * (1 + 1e-9)  # bits below f32's: the cast rounds
    base = base.astype(dtype)
    if layout == "strided":
        return base[::2, :, ::2]
    if layout == "reversed":
        return base[: shape[0], ::-1, : shape[2]]
    vol = np.ascontiguousarray(base[: shape[0], :, : shape[2]])
    if layout == "fortran":
        return np.asfortranarray(vol)
    if layout == "read_only":
        vol.flags.writeable = False
    return vol


def _cpu_ring(monkeypatch, chunk, depth):
    """A CPU ring of `depth` slots of `chunk` f32 elements."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", 4 * chunk)
    monkeypatch.setattr(staging, "DEPTH", depth)
    return StagingRing("cpu")


def _staged_cpu(ring, imgs, threads=None):
    """imgs staged through ring into one batch; threads: inside
    ``staging.shared_copy(threads)``."""
    batch = torch.full((len(imgs),) + tuple(np.shape(imgs[0])), np.nan)
    with staging.shared_copy(threads) if threads else contextlib.nullcontext():
        for b, img in enumerate(imgs):
            ring.stage(img, batch[b])
    return batch


def _want(img):
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    return torch.from_numpy(np.array(img, np.float32))


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("threads", [None, 1, 3], ids=["own_routes", "shared_1", "shared_3"])
@pytest.mark.parametrize("size", list(SIZES), ids=list(SIZES))
@pytest.mark.parametrize("layout", ["contiguous", "read_only", "fortran", "strided", "reversed"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8, ">i2"],
                         ids=["f32", "f64", "int16", "uint8", "int16_big_endian"])
def test_ring_walk_gives_the_bits_of_np_array(monkeypatch, dtype, layout, size, threads):
    """threads: the ring's own routes, or shared_copy's on 1 or 3 threads
    (the ragged size's last chunk, 25 elements, no multiple of 3)."""
    vol = _array(SIZES[size], dtype, layout, np.random.default_rng(3))
    assert vol.flags.c_contiguous == (layout in ("contiguous", "read_only"))
    got = _staged_cpu(_cpu_ring(monkeypatch, CHUNK, 3), [vol], threads)[0]
    assert _bits_equal(got, _want(vol))


@pytest.mark.parametrize("shape, chunk, pieces", [((1, 1, 2), CHUNK, 2), ((5, 7, 11), 8, 3)],
                         ids=["chunk_shorter_than_k", "chunks_no_multiple_of_k"])
def test_shared_copy_splits_each_chunk_over_its_threads(monkeypatch, shape, chunk, pieces):
    """k = 3: a chunk of 2 elements copies as 2 pieces of one element, on
    this thread and one worker; chunks of 8 (385 elements: 48 of them and
    one of 1) as 3, 3 and 2 on this thread and two workers, the last as 1.
    Every piece is numpy's copy, and the bits are np.array's."""
    ring = _cpu_ring(monkeypatch, chunk, 2)
    seen = []
    numpy_copy = staging._numpy_copy
    monkeypatch.setattr(staging, "_numpy_copy", lambda d, s: (seen.append((threading.get_ident(), d.size)), numpy_copy(d, s)))
    monkeypatch.setattr(staging, "_tensor_copy", lambda d, s: pytest.fail("torch's copy on the shared route"))
    vol = _array(shape, np.float64, "strided", np.random.default_rng(11))
    got = _staged_cpu(ring, [vol], threads=3)[0]
    assert _bits_equal(got, _want(vol))
    assert len({t for t, _ in seen}) == pieces and threading.get_ident() in {t for t, _ in seen}
    assert sum(n for _, n in seen) == vol.size


def test_torch_copies_what_it_can_view_and_numpy_the_rest(monkeypatch):
    """A read-only array is copied through a tensor over its own memory,
    with no warning; another byte order or a negative stride by numpy."""
    rng = np.random.default_rng(4)
    ro = _array(SIZES["ragged"], np.int16, "read_only", rng)
    view = staging._source(ro, parallel=True)
    assert isinstance(view, torch.Tensor) and view.data_ptr() == ro.ctypes.data and not ro.flags.writeable
    assert staging._source(ro, parallel=False) is ro
    for arr in (_array(SIZES["ragged"], ">i2", "contiguous", rng), _array(SIZES["ragged"], np.float64, "reversed", rng)):
        assert isinstance(staging._source(arr, parallel=True), np.ndarray)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _staged_cpu(_cpu_ring(monkeypatch, CHUNK, 2), [ro])[0]
    assert _bits_equal(got, _want(ro))


def test_a_batch_copies_on_torch_threads_and_a_single_volume_on_this_one(monkeypatch):
    """Through the card's route on a CPU ring: a batch of several volumes
    copies by torch, a volume alone (``device_volume``, ``_batch`` of one)
    by numpy; the bits are np.array's either way."""
    ring = _cpu_ring(monkeypatch, CHUNK, 2)
    monkeypatch.setattr(extract, "_staged", lambda img, dev: not isinstance(img, torch.Tensor))
    monkeypatch.setattr(staging, "ring", lambda dev: ring)
    used = []
    for name in ("_numpy_copy", "_tensor_copy"):
        monkeypatch.setattr(staging, name, lambda d, s, f=getattr(staging, name), n=name: (used.append(n), f(d, s)))
    rng = np.random.default_rng(8)
    imgs = [_array(SIZES["ragged"], np.int16, "read_only", rng) for _ in range(2)]
    got = extract._batch(imgs, SIZES["ragged"], torch.device("cpu"))
    assert set(used) == {"_tensor_copy"} and all(_bits_equal(got[b], _want(v)) for b, v in enumerate(imgs))
    used.clear()
    one = extract.device_volume(imgs[0], "cpu")
    assert set(used) == {"_numpy_copy"} and _bits_equal(one, _want(imgs[0]))


def test_more_volumes_than_slots_and_cpu_tensors(monkeypatch):
    """Seven volumes through two slots, numpy and CPU tensors (f64, a
    transposed view, int16) mixed, each chunk in its place."""
    rng = np.random.default_rng(5)
    shape = SIZES["ragged"]
    imgs = [_array(shape, np.float64, "contiguous", rng), torch.from_numpy(_array(shape, np.float64, "strided", rng)),
            torch.from_numpy(_array(shape[::-1], np.float32, "contiguous", rng)).permute(2, 1, 0),
            _array(shape, np.uint8, "fortran", rng), torch.from_numpy(_array(shape, np.int16, "contiguous", rng)),
            _array(shape, np.int16, "read_only", rng), _array(shape, np.float32, "strided", rng)]
    ring = _cpu_ring(monkeypatch, CHUNK, 2)
    got = _staged_cpu(ring, imgs)
    for b, img in enumerate(imgs):
        assert _bits_equal(got[b], _want(img)), b
    assert ring._next == (len(imgs) * -(-np.prod(shape) // CHUNK)) % 2


def test_a_shape_mismatch_raises(monkeypatch):
    ring = _cpu_ring(monkeypatch, CHUNK, 2)
    with pytest.raises(ValueError, match="staged into"):
        ring.stage(np.zeros((2, 3, 4)), torch.empty(2, 4, 3))


@pytest.mark.parametrize("share", [None, 3], ids=["own_routes", "shared_3"])
def test_threads_staging_through_one_ring_get_their_own_bits(monkeypatch, share):
    """Eight threads, more than this test's cores, stage through one ring of
    two slots at a short switch interval: no chunk lands in another's slot.
    shared_3: each inside shared_copy(3), so the ring's two workers copy
    pieces of every thread's chunks."""
    ring = _cpu_ring(monkeypatch, CHUNK, 2)
    rng = np.random.default_rng(9)
    work = [[_array(SIZES["ragged"], np.float64, "strided", rng) for _ in range(6)] for _ in range(8)]
    results = [None] * len(work)

    def run(t):
        results[t] = _staged_cpu(ring, work[t], share)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(len(work))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for t, imgs in enumerate(work):
        for b, img in enumerate(imgs):
            assert _bits_equal(results[t][b], _want(img)), (t, b)


@pytest.fixture(scope="module")
def volumes():
    """Two shape groups: 48^3 (synthetic_volume, 14 and 3 features) and
    40x44x36 (blob textures, 9 and 3 features)."""
    return [synthetic_volume(48, seed=7), synthetic_blob_texture((40, 44, 36), seed=8, n_blobs=30),
            synthetic_volume(48, seed=3), synthetic_blob_texture((40, 44, 36), seed=6, n_blobs=30)]


@pytest.fixture(scope="module")
def singles(volumes):
    return [extract_features(v, device="cpu") for v in volumes]


@pytest.mark.parametrize("route", ["plain", "ring"])
def test_many_on_mixed_inputs_keeps_order_and_bits(monkeypatch, volumes, singles, route):
    """numpy (one read-only, one F-ordered) and CPU-tensor inputs of two
    shapes, interleaved: each result equals its volume alone. "ring": the
    host inputs go through a CPU ring of small slots, the card's route."""
    if route == "ring":
        cpu_ring = _cpu_ring(monkeypatch, 4096, 2)
        monkeypatch.setattr(extract, "_staged", lambda img, dev: not isinstance(img, torch.Tensor) or img.device.type == "cpu")
        monkeypatch.setattr(staging, "ring", lambda dev: cpu_ring)
    ro = volumes[2].copy()
    ro.flags.writeable = False
    order = [1, 0, 3, 2, 0]
    inputs = [volumes[1], torch.from_numpy(volumes[0]), torch.from_numpy(volumes[3].astype(np.float64)), ro,
              np.asfortranarray(volumes[0])]
    got = extract_features_many(inputs, device="cpu")
    assert len(got) == len(order)
    for g, i in zip(got, order):
        want = singles[i]
        assert len(g) == len(want)
        for k in FIELDS:
            a, b = getattr(g, k), getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, k)
    assert all(len(f) > 0 for f in singles)


def test_a_volume_not_zyx_raises_before_any_upload(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a volume was converted before the shapes were checked")

    monkeypatch.setattr(extract, "_volume", refuse)
    monkeypatch.setattr(extract, "_batch", refuse)
    with pytest.raises(ValueError, match=r"expected a \[Z, Y, X\] volume, got shape \(8, 8\)"):
        extract_features_many([np.zeros((8, 8, 8), np.float32), np.zeros((8, 8), np.float32)], device="cpu")
    with pytest.raises(ValueError, match=r"got shape \(1, 8, 8, 8\)"):
        extract_features(torch.zeros(1, 8, 8, 8), device="cpu")


def test_count_is_nothing_outside_record_and_summed_inside():
    tracer = Tracer()
    tracer.count("staged_volumes")
    assert tracer.counts == {}
    with tracer.record():
        threads = [threading.Thread(target=lambda: [tracer.count("staged_bytes", 7) for _ in range(500)])
                   for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        tracer.count("staged_volumes")
        tracer.count("slot_waits", 0)
        with tracer.stage("input"):
            tracer.count("staged_volumes", 2)
    tracer.count("staged_volumes", 100)  # after the record: not kept
    assert not any(th.is_alive() for th in threads)
    assert tracer.counts == {"staged_bytes": 4 * 500 * 7, "staged_volumes": 3, "slot_waits": 0}
    lines = tracer.summary().splitlines()
    assert lines[0].split()[0] == "span" and lines[1].split()[:2] == ["input", "1"]
    assert lines[2].split() == ["counter", "count"]
    assert lines[3:] == [f"{'staged_bytes':24s} {14000:17d}", f"{'staged_volumes':24s} {3:17d}",
                         f"{'slot_waits':24s} {0:17d}"]
    with tracer.record():
        pass
    assert tracer.counts == {} and "counter" not in tracer.summary()


def test_the_process_tracer_counts_nothing_unless_recording(monkeypatch):
    before = dict(TRACER.counts)
    _cpu_ring(monkeypatch, CHUNK, 2).stage(np.ones((2, 3, 4)), torch.empty(2, 3, 4))
    assert TRACER.counts == before
    with TRACER.record():
        _cpu_ring(monkeypatch, CHUNK, 2).stage(np.ones((3, 5, 9)), torch.empty(3, 5, 9))
        counts = dict(TRACER.counts)
    assert counts == {"staged_volumes": 1, "staged_bytes": 4 * 135, "shared_copy_volumes": 0, "slot_waits": 0}


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _device_volumes(count, dims, seed, dev):
    """`count` blob textures of `dims` made on dev (a few separable
    Gaussian blobs over a ramp), as writable f32 host arrays."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    axes = [torch.arange(d, **f32) for d in dims]
    out = []
    for _ in range(count):
        vol = 50.0 + 0.2 * axes[0][:, None, None] + 0.1 * axes[2][None, None, :]
        for _ in range(40):
            c = torch.rand(3, generator=gen, **f32) * torch.tensor(dims, **f32)
            s = 2.0 + 4.0 * torch.rand((), generator=gen, **f32)
            a = -150.0 + 400.0 * torch.rand((), generator=gen, **f32)
            g = [torch.exp(-((ax - c[k]) ** 2) / (2 * s * s)) for k, ax in enumerate(axes)]
            vol = vol + a * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
        out.append(vol.cpu().numpy())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8], ids=["f32", "f64", "int16", "uint8"])
def test_staged_upload_equals_the_plain_upload_on_the_card(card, dtype):
    """T1-sized (several chunks) and ragged volumes, every layout, and a CPU
    tensor: the staged batch (torch's copy) and each volume staged alone
    (numpy's) equal ``_volume``'s upload, bit for bit."""
    rng = np.random.default_rng(1)
    imgs = [_array(MNI_T1_DIMS, dtype, layout, rng) for layout in ("contiguous", "read_only", "fortran", "strided")]
    imgs.append(torch.from_numpy(_array(MNI_T1_DIMS, dtype, "strided", rng)))
    got = extract._batch(imgs, MNI_T1_DIMS, card)
    for b, img in enumerate(imgs):
        assert _bits_equal(got[b], extract._volume(img, card)), b
        assert _bits_equal(extract.device_volume(img, card), extract._volume(img, card)), b  # numpy's copy
    odd = [_array((37, 75, 61), dtype, "fortran", rng) for _ in range(3)]
    got = extract._batch(odd, (37, 75, 61), card)
    assert all(_bits_equal(got[b], extract._volume(img, card)) for b, img in enumerate(odd))


@pytest.mark.cuda
def test_many_on_32_t1_volumes_equals_the_plain_upload(card):
    vols = _device_volumes(32, MNI_T1_DIMS, 18, card)
    staged = extract_features_many(vols, device=card)
    plain = extract_features_many([extract._volume(v, card) for v in vols], device=card)
    assert len(staged) == len(plain) == 32 and sum(len(f) for f in plain) > 32 * 100
    for g, w in zip(staged, plain):
        for k in FIELDS:
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.cuda
def test_a_staged_call_has_no_pageable_upload_and_no_sync_inside_input(card, monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    vols = _device_volumes(4, MNI_T1_DIMS, 4, card)
    extract_features_many(vols[:1], device=card)  # the ring and the kernels exist before the trace

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize called")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with monkeypatch.context() as m:  # the profiler's own exit synchronizes
            m.setattr(torch.cuda, "synchronize", refuse)
            extract_features_many(vols, device=card)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == timing.PREFIX + "input"]
    assert len(spans) == 1
    lo, hi = spans[0]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi]
    names = {e["name"] for e in runtime}
    assert not {"cudaDeviceSynchronize", "cudaStreamSynchronize"} & names, names
    inside = {e["args"].get("correlation") for e in runtime}
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy" and e["args"].get("correlation") in inside]
    chunks = 4 * -(-int(np.prod(MNI_T1_DIMS)) // (staging.CHUNK_BYTES // 4))
    assert len(copies) == chunks and all("HtoD" in c and "Pinned" in c for c in copies), copies
    assert not [e["name"] for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                and "Pageable" in e["name"] and e["args"].get("correlation") in inside]


@pytest.mark.cuda
def test_two_threads_staging_to_two_cards_get_their_bits(card):
    """One thread a card (both on cuda:0 with one card), each staging its
    own T1 volumes, at a short switch interval."""
    from sift3d_torch.dist.batch import on_device

    devs = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(2)]
    rng = np.random.default_rng(2)
    work = [[_array(MNI_T1_DIMS, dt, "strided", rng) for dt in (np.float32, np.int16, np.float64)] for _ in devs]
    results = [None, None]

    def run(t):
        with on_device(devs[t]):
            results[t] = extract._batch(work[t], MNI_T1_DIMS, devs[t])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for t, imgs in enumerate(work):
        for b, img in enumerate(imgs):
            assert _bits_equal(results[t][b], extract._volume(img, devs[t])), (t, b)
    if devs[0] != devs[1]:
        assert staging.ring(devs[0]) is not staging.ring(devs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["every_card", "one_card"])
def test_four_placed_threads_share_the_copy_and_keep_the_bits(card, cards):
    """Four threads stage on shared_copy's route onto cuda:0-3 (each card
    index modulo the cards present) or all onto cuda:0, at a short switch
    interval: each staged batch equals ``_volume``'s upload bit for bit.
    Then extract_features_batch over the same mesh: every volume on the
    shared route, each group's FeatureSets those of extract_features_many."""
    from sift3d_torch.dist import batch

    mesh = [torch.device("cuda", i % torch.cuda.device_count() if cards == "every_card" else 0) for i in range(4)]
    rng = np.random.default_rng(6)
    work = [[_array(MNI_T1_DIMS, dt, "strided", rng) for dt in (np.float32, np.int16)] for _ in mesh]
    results = [None] * len(mesh)

    def run(t):
        with batch.on_device(mesh[t]), staging.shared_copy(batch.copy_threads(len(mesh))):
            results[t] = extract._batch(work[t], MNI_T1_DIMS, mesh[t])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(len(mesh))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for t, imgs in enumerate(work):
        for b, img in enumerate(imgs):
            assert _bits_equal(results[t][b], extract._volume(img, mesh[t])), (t, b)
    vols = _device_volumes(8, MNI_T1_DIMS, 21, card)
    with TRACER.record():
        got = batch.extract_features_batch(vols, mesh)
        counts = dict(TRACER.counts)
    assert counts["shared_copy_volumes"] == counts["staged_volumes"] == len(vols)
    for e, dev in enumerate(mesh):
        with batch.on_device(dev):
            want = extract_features_many(vols[e :: len(mesh)], device=dev)
        for g, w in zip(got[e :: len(mesh)], want):
            for k in FIELDS:
                a, b = getattr(g, k), getattr(w, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), (e, k)


@pytest.mark.cuda
def test_featextract_time_prints_the_staging_counts(card, tmp_path, capsys):
    from sift3d_torch.cli import featextract
    from sift3d_torch.io import nifti

    vol = synthetic_volume(48, seed=7)
    src = str(tmp_path / "v.nii")
    nifti.write(src, vol)
    assert not nifti.read_volume(src).data.flags.writeable
    keys = {}
    for where, device, argv in (("card", None, ["--time"]), ("cpu", "cpu", [])):
        (tmp_path / where).mkdir()
        with contextlib.chdir(tmp_path / where):
            assert featextract.main(argv + [src, "v.key"], device=device) == 0
        keys[where] = (tmp_path / where / "v.key").read_bytes()
        printed = capsys.readouterr().out
        if where == "card":
            rows = {line.split()[0]: line.split() for line in printed.splitlines() if line.split()}
            assert rows["staged_volumes"][1] == "1" and rows["staged_bytes"][1] == str(4 * vol.size)
            assert rows["slot_waits"][1] == "0" and rows["input"][1] == "1"
            assert rows["shared_copy_volumes"][1] == "0"
    assert keys["card"] == keys["cpu"] and keys["cpu"].count(b"\n") > 10
