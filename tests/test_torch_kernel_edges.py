"""PyTorch port: K7's and K3/K8/K9's plain versions at the edge shapes the
redesigned kernels must handle, and the launch geometry of K7.

- The plain blur against the exact numpy fma chain (test_torch_blur.py's
  `fma_chain_blur3d`, what csrc/blur3d.cu computes) on volumes thinner
  than 2r + 1 along each axis in turn, sizes that are no multiple of a
  tile, a batch of three volumes, and every radius 1..8: bit for bit.
- K3's plain version against the JAX package's CPU path
  (_smooth_histogram_axes + _top_peaks) with V in {1, 127, 128, 129, 485},
  an all-zero-weight row and two exactly tied peaks: histogram values equal
  to the bit, equal peak sets and positions. K8's plain version against
  the JAX CPU splat at tests/test_hist_pallas.py's 2e-5.
- Skipping exact zero products, as csrc/hist_topk.cu's warps do, leaves
  the chunked fma chain's bits unchanged.
- The plain blur at the deepest octave of the T1 grid (5x6x5): only its y
  pass leaves the chain, by rounding.
- blur_launch_geometry: launches the kernels take, with at least 2 x 132
  blocks wherever the shape allows that many.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig
from sift3d.pipeline import features as jx_features
from sift3d_torch.core.numerics import fma_exact
from sift3d_torch.kernels import gauss, gauss_cuda, hist_cuda
from sift3d_torch.kernels.resample import interp_bin
from test_torch_blur import fma_chain_axis, fma_chain_blur3d

torch.set_num_threads(1)
CFG = SiftConfig()
LEVEL5 = CFG.incremental_sigmas()[-1]  # radius 8
# the smallest sigmas of radii 1..8 at the 0.01 tail rule, within a step
RADIUS_SIGMAS = (0.5, 0.95, 1.2, 1.6, 2.0, 2.4, 2.8, LEVEL5)
BAND = torch.from_numpy(hist_cuda.hist_band(gauss.gaussian_kernel_1d(CFG.ori_hist_blur_sigma, 0.01)))


@pytest.mark.parametrize(
    "shape, sigma",
    [
        ((5, 40, 300), LEVEL5),  # z thinner than 2r + 1
        ((300, 7, 40), LEVEL5),  # y
        ((40, 300, 9), LEVEL5),  # x
        ((37, 75, 61), 1.6),  # no axis a multiple of a 32 x 32 tile
        ((3, 45, 54, 45), LEVEL5),  # a batch of three octave-2 volumes
    ],
)
def test_plain_blur_is_the_fma_chain_at_edge_shapes(shape, sigma):
    vol = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = gauss_cuda.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy()
    np.testing.assert_array_equal(got, fma_chain_blur3d(vol, sigma))


@pytest.mark.parametrize("radius", range(1, 9))
def test_plain_blur_is_the_fma_chain_at_every_radius(radius):
    sigma = RADIUS_SIGMAS[radius - 1]
    assert len(gauss.gaussian_kernel_1d(sigma, 0.01)) == 2 * radius + 1
    vol = np.random.default_rng(radius).standard_normal((24, 28, 26)).astype(np.float32)
    got = gauss_cuda.blur3d(torch.from_numpy(vol), sigma, 0.01).numpy()
    np.testing.assert_array_equal(got, fma_chain_blur3d(vol, sigma))


def test_plain_blur_leaves_the_chain_only_in_the_y_pass_at_5x6x5():
    """At the T1 grid's deepest octave (5 x 6 x 5) and r = 8, PyTorch's CPU
    matmul sums the y pass in another order than the chain: the x and z
    passes are the chain; the y pass is within what reordering a sum of at
    most 6 terms allows, 5 ulps of the sum of the terms' magnitudes; and
    the blur is the chain's z pass of the matmul's y pass of the chain's
    x pass. K7 is the chain (chip_smoke.py's phase 2 holds it to the
    chain at this shape)."""
    vol = np.random.default_rng(0).standard_normal((5, 6, 5)).astype(np.float32)
    taps = gauss.gaussian_kernel_1d(LEVEL5, 0.01)
    assert len(taps) == 17

    def plain(v, axis):
        return gauss.blur_axis(torch.from_numpy(v), axis, LEVEL5, 0.01).numpy()

    xp = plain(vol, 2)
    np.testing.assert_array_equal(xp, fma_chain_axis(vol, taps, 2))
    yp, yc = plain(xp, 1), fma_chain_axis(xp, taps, 1)
    assert not np.array_equal(yp, yc)
    magnitude = fma_chain_axis(np.abs(xp), taps, 1)
    assert (np.abs(yp - yc) <= 5 * np.spacing(magnitude)).all()
    zp = plain(yp, 0)
    np.testing.assert_array_equal(zp, fma_chain_axis(yp, taps, 0))
    np.testing.assert_array_equal(gauss.blur3d(torch.from_numpy(vol), LEVEL5, 0.01).numpy(), zp)


def _rows(c, v, seed):
    """c rows of v unit directions at bin coordinates, weights >= 0."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((c, v, 3)).astype(np.float32)
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-6)
    w = np.abs(rng.standard_normal((c, v))).astype(np.float32)
    # 0.5-centred coordinates (the JAX functions') minus 0.5: exact, and
    # exactly undone by the + 0.5 the JAX calls below add back
    centred = e * np.float32(5) + np.float32(5.5)
    return [np.ascontiguousarray(centred[..., i] - np.float32(0.5)) for i in range(3)] + [w]


def _tied():
    """Two single-bin points at mirrored x and a weaker third: two peaks of
    exactly equal value (tests/test_torch_hist.py's tie rows)."""
    pts = [np.full((2, 3), 5.0, np.float32) for _ in range(3)] + [np.tile(np.float32([1, 1, 0.5]), (2, 1))]
    pts[0][0], pts[0][1] = [7.0, 3.0, 9.0], [3.0, 7.0, 1.0]
    return pts


def _zero_row():
    pts = _rows(3, 485, 5)
    pts[3][1] = 0.0
    return pts


EDGE_ROWS = {
    **{f"V={v}": (lambda v=v: _rows(4, v, v)) for v in (1, 127, 128, 129, 485)},
    "zero-weight row": _zero_row,
    "tied peaks": _tied,
}


@pytest.mark.parametrize("case", sorted(EDGE_ROWS))
def test_topk_matches_jax_cpu_path_at_edge_rows(case):
    pts = EDGE_ROWS[case]()
    k = 6
    hist = jx_features._smooth_histogram_axes(
        *(jnp.asarray(u + np.float32(0.5)) for u in pts[:3]), jnp.asarray(pts[3]), CFG.ori_hist_blur_sigma
    )
    vals, pz, py, px, valid = (np.asarray(t) for t in jx_features._top_peaks(hist, k))
    out = hist_cuda.hist_topk(*(torch.from_numpy(a) for a in pts), BAND, k).numpy()
    ok = np.isfinite(out[..., 0])
    np.testing.assert_array_equal(ok, valid)
    np.testing.assert_array_equal(out[..., 0][ok], vals[ok])
    flat = out[..., 7].astype(np.int64)
    np.testing.assert_array_equal((flat // 16 // 11)[ok], pz[ok])
    np.testing.assert_array_equal((flat // 16 % 11)[ok], py[ok])
    np.testing.assert_array_equal((flat % 16)[ok], px[ok])
    if case == "zero-weight row":
        assert not ok[1].any()  # no peak in an all-zero histogram
    if case == "tied peaks":
        assert out[0, 0, 0] == out[0, 1, 0] and (flat[:, :2] % 16 == [3, 7]).all()


@pytest.mark.parametrize("case", sorted(EDGE_ROWS))
def test_raw_splat_matches_jax_at_edge_rows(case):
    pts = EDGE_ROWS[case]()
    got = hist_cuda.splat_histogram_raw_bins(*(torch.from_numpy(a) for a in pts)).numpy()
    want = np.asarray(jx_features._splat_histogram(
        jnp.asarray(np.stack(pts[:3], axis=-1) + np.float32(0.5)), jnp.asarray(pts[3])
    ))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _skipping_chain(cx, cy, cz, w, band):
    """csrc/hist_topk.cu's accumulation: thread (y, x) of a 128-thread row
    sums its 11 z bins over each 128-point chunk, and each warp of 32
    threads skips the points whose nonzero y factors miss the warp's y rows
    or whose weighted z factors are all zero. Returns the histograms and
    the share of (warp, point) pairs skipped."""
    p = hist_cuda.PATCH_DIM

    def factors(u):
        i0, w0 = interp_bin(u, p)
        return w0[..., None] * band[i0] + (1.0 - w0)[..., None] * band[i0 + 1]

    fx, fy = factors(cx), factors(cy)
    fz = w[..., None] * factors(cz)
    c, v_total = cx.shape
    tid = torch.arange(121)
    ty, tx, warp = tid // p, tid % p, tid // 32
    warp_lo, warp_hi = (warp * 32) // p, torch.clamp((warp * 32 + 31) // p, max=p - 1)
    hist = torch.zeros((c, p, 121))
    skipped = 0
    for v0 in range(0, v_total, hist_cuda.CHUNK):
        part = torch.zeros_like(hist)
        for v in range(v0, min(v0 + hist_cuda.CHUNK, v_total)):
            nz = fy[:, v] != 0
            lo = torch.where(nz.any(1), nz.float().argmax(1), torch.full((c,), p))
            hi = torch.where(nz.any(1), p - 1 - nz.flip(1).float().argmax(1), torch.full((c,), -1))
            live = ((fz[:, v] != 0).any(1)[:, None] & (lo[:, None] <= warp_hi) & (hi[:, None] >= warp_lo))
            prod = fy[:, v, ty] * fx[:, v, tx]  # [C, 121]
            step = fma_exact(fz[:, v, :, None].expand_as(part), prod[:, None, :].expand_as(part), part)
            part = torch.where(live[:, None, :], step, part)
            skipped += int((~live[:, ::32]).sum())
        hist = hist + part
    return hist.reshape(c, p, p, p), skipped / (c * v_total * 4)


@pytest.mark.parametrize("band_name", ["sigma 0.5", "identity"])
@pytest.mark.parametrize("case", ["V=129", "zero-weight row", "tied peaks"])
def test_skipping_zero_products_keeps_the_bits(case, band_name):
    pts = [torch.from_numpy(a) for a in EDGE_ROWS[case]()]
    band = BAND if band_name == "sigma 0.5" else torch.eye(hist_cuda.PATCH_DIM)
    want = hist_cuda.splat_blur_plain(*pts, band)
    got, skipped = _skipping_chain(*pts, band)
    assert skipped > 0.3  # most warps skip most points
    assert torch.equal(got, want)


@pytest.mark.parametrize("band_name", ["sigma 0.5", "identity", "full"])
@pytest.mark.parametrize("weights", ["finite", "with inf and nan"])
def test_plain_splat_box_is_the_whole_splat(band_name, weights):
    """splat_blur_plain updates only each point's box of nonzero factors;
    against every bin for every point (hist_cuda._splat_full) on points
    that reach past both ends of the grid, with zero and negative weights:
    the same bits. A band without zeros, or a non-finite weight, takes the
    whole splat."""
    rng = np.random.default_rng(12)
    c, v = 24, 300
    cx, cy, cz = (torch.from_numpy(rng.uniform(-1.5, 11.5, (c, v)).astype(np.float32)) for _ in range(3))
    w = torch.from_numpy((rng.standard_normal((c, v)) * (rng.random((c, v)) > 0.2)).astype(np.float32))
    if weights != "finite":
        w[3, 7], w[5, 9] = float("inf"), float("nan")
    band = {"sigma 0.5": BAND, "identity": torch.eye(hist_cuda.PATCH_DIM),
            "full": torch.full((hist_cuda.PATCH_DIM,) * 2, 0.1)}[band_name]

    def factors(u):
        i0, w0 = interp_bin(u, hist_cuda.PATCH_DIM)
        return w0[..., None] * band[i0] + (1.0 - w0)[..., None] * band[i0 + 1]

    want = hist_cuda._splat_full(factors(cx), factors(cy), w[..., None] * factors(cz),
                                 torch.zeros((c,) + (hist_cuda.PATCH_DIM,) * 3))
    got = hist_cuda.splat_blur_plain(cx, cy, cz, w, band)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _octave_shapes(dims):
    shapes = []
    z, y, x = dims
    while z > 2 and y > 2 and x > 2:
        shapes.append((1, z, y, x))
        z, y, x = z // 2, y // 2, x // 2
    return shapes


GRID_SHAPES = _octave_shapes((182, 218, 182)) + _octave_shapes((364, 436, 364)) + [(4096, 11, 11, 11)]


def _blocks(geom, shape):
    """The blocks of each launch of geom, counted from its numbers as
    csrc/blur3d.cu's launch code counts them."""
    b, z, y, x = shape
    if geom["kind"] == "small":
        return [-(-b // geom["vpb"])]
    seg, bx, by = geom["z"]
    xy = b * z * -(-x // gauss_cuda.TILE_X) * -(-y // (gauss_cuda.THREAD_ROWS * geom["ry"]))
    return [xy, b * -(-(y * x) // bx) * -(-(-(-z // seg)) // by)]


@pytest.mark.parametrize("shape", GRID_SHAPES, ids=str)
def test_launch_geometry_fills_the_card(shape):
    """Every launch within what the kernels take, and >= 2 x 132 blocks
    wherever the kernels' smallest blocks allow that many (the deepest
    octaves do not). That each output is written once is phase 2's exact
    check on the card, at the chosen and at other launches."""
    b, z, y, x = shape
    for r in range(1, 9):
        g = gauss_cuda.blur_launch_geometry(shape, r, n_sm=132)
        if g["kind"] == "small":
            assert z <= gauss_cuda.SMALL_Z and 1 <= g["vpb"] and g["vpb"] * y * x <= gauss_cuda.SMALL_COLS
            most = [b]
        else:
            assert g["kind"] == "xy_z" and g["ry"] in (1, 2, 4, 8) and g["z"] in gauss_cuda.Z_SHAPES
            most = _blocks(dict(kind="xy_z", ry=1, z=gauss_cuda.Z_SHAPES[-1]), shape)
        for blocks, m in zip(_blocks(g, shape), most, strict=True):
            assert blocks >= min(2 * 132, m), (shape, r, g, blocks)
