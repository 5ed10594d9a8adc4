"""PyTorch port: the extrema mask (K1/K6) at the edges of csrc/dogs_extrema.cu.

- A torch model of the kernel's decomposition (row3 -> R8 and B9 -> the
  80-neighbour max and min over planes and levels, NaN-propagating) equals
  the plain mask (``kernels/extrema.extrema_mask``) bit for bit on inputs
  with plateaus, exact ties, +-0, +-inf and NaN planted on the seams of the
  kernel's tiles, warps and z runs, on extents of 3 and 4 along each axis and
  on a shape that no tile divides.
- On the same inputs the plain mask equals the JAX package's lax stencil
  and its Pallas kernel in interpret mode.
- ``extrema_launch_geometry``: every voxel is written by exactly one thread
  of the chosen launch (each axis's tiles, as the kernel assigns them), the
  mask's inside by exactly one centre-plane emission, and the launch has at
  least 2 x 132 blocks wherever one of the kernel's launches has that many.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.kernels import extrema as jx_extrema
from sift3d.kernels.extrema_pallas import extrema_mask_pallas
from sift3d_torch.kernels import extrema_cuda
from sift3d_torch.kernels.extrema import extrema_mask
from sift3d_torch.utils.synthetic import extrema_edge_stack

torch.set_num_threads(1)

EDGE_SHAPES = [
    (3, 40, 70), (40, 3, 70), (40, 70, 3),  # an inside one voxel thick
    (4, 40, 70), (40, 4, 70), (40, 70, 4),
    (37, 75, 61),  # no axis a multiple of a tile
    (19, 33, 64),  # x across two warps' seams (30, 60)
]


def _span(a, b):
    return torch.maximum(a[0], b[0]), torch.minimum(a[1], b[1])


def _span_v(a, v):
    return torch.maximum(a[0], v), torch.minimum(a[1], v)


def decomposed_mask(dogs: torch.Tensor) -> torch.Tensor:
    """The mask of [5, Z, Y, X] DoGs as csrc/dogs_extrema.cu builds it: per
    level and plane row3 (x - 1..x + 1), R8 (row3 at y - 1 and y + 1 and the
    two x neighbours) and B9 (R8 and the centre); for centre level c,
    U = B9 of levels c - 1 and c + 1 and W = U with B9 of level c, and the 80
    neighbours at plane z are W(z - 1), U(z), R8(z) and W(z + 1). torch's
    maximum and minimum propagate NaN, as PTX max.NaN / min.NaN do. Borders
    wrap around and are zeroed after, as the plain mask's are."""

    def sh(t, axis, k):
        return torch.roll(t, k, dims=axis)

    row3 = _span_v((sh(dogs, -1, 1), sh(dogs, -1, 1)), dogs)
    row3 = _span_v(row3, sh(dogs, -1, -1))
    r8 = _span((sh(row3[0], -2, 1), sh(row3[1], -2, 1)), (sh(row3[0], -2, -1), sh(row3[1], -2, -1)))
    r8 = _span_v(_span_v(r8, sh(dogs, -1, 1)), sh(dogs, -1, -1))
    b9 = _span_v(r8, dogs)
    out = []
    for c in (1, 2, 3):
        u = _span((b9[0][c - 1], b9[1][c - 1]), (b9[0][c + 1], b9[1][c + 1]))
        w = _span(u, (b9[0][c], b9[1][c]))
        n = _span(_span((sh(w[0], 0, 1), sh(w[1], 0, 1)), u), (r8[0][c], r8[1][c]))
        n = _span(n, (sh(w[0], 0, -1), sh(w[1], 0, -1)))
        v = dogs[c]
        out.append((v > n[0]).to(torch.int8) - (v < n[1]).to(torch.int8))
    mask = torch.stack(out)
    interior = torch.zeros(dogs.shape[1:], dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    return torch.where(interior, mask, torch.zeros_like(mask))


def _edge_dogs(shape, seed):
    return extrema_edge_stack(shape, 5, seed)


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_decomposition_equals_the_plain_mask(shape):
    dogs = torch.from_numpy(_edge_dogs(shape, sum(shape)))
    assert torch.isnan(dogs).any() and torch.isinf(dogs).any()
    want = extrema_mask(dogs)
    got = decomposed_mask(dogs)
    assert torch.equal(got, want)
    if min(shape) >= 4:
        assert (want == 1).any() and (want == -1).any()


def test_nan_voids_its_neighbourhood_and_signed_zeros_tie():
    """A strict maximum stays 0 when one of its 80 neighbours is NaN; a +0
    among -0s is no extremum; a strict maximum next to a -inf stays one."""
    dogs = np.zeros((5, 5, 5, 5), np.float32)
    dogs[:, 2, 2, 2] = -1.0
    dogs[2, 2, 2, 2] = 1.0  # strict maximum of level 2 (c = 1)
    cases = {}
    for what, level, pos, val in (("nan", 1, (1, 3, 2), np.nan), ("-inf", 3, (3, 1, 1), -np.inf)):
        d = dogs.copy()
        d[(level,) + pos] = val
        cases[what] = d
    zeros = np.full((5, 5, 5, 5), -0.0, np.float32)
    zeros[2, 2, 2, 2] = 0.0
    cases["+0 among -0"] = zeros
    want = {"nan": 0, "-inf": 1, "+0 among -0": 0}
    for what, d in cases.items():
        t = torch.from_numpy(d)
        plain = extrema_mask(t)
        assert int(plain[1, 2, 2, 2]) == want[what], what
        assert torch.equal(decomposed_mask(t), plain), what


@pytest.mark.parametrize("shape", EDGE_SHAPES[:1] + EDGE_SHAPES[6:], ids=str)
def test_plain_mask_matches_jax_on_edge_inputs(shape):
    """The JAX package's lax stencil and its Pallas kernel (interpret mode)
    give the plain mask on the same edge inputs, NaN and signed zeros
    included: jnp.maximum propagates NaN as the kernel's max.NaN does."""
    d = _edge_dogs(shape, 1 + sum(shape))
    got = extrema_mask(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jx_extrema.extrema_mask(jnp.asarray(d))))
    np.testing.assert_array_equal(got, np.asarray(extrema_mask_pallas(jnp.asarray(d), interpret=True)))


def test_plain_batch_matches_jax_on_edge_inputs():
    d = np.stack([_edge_dogs((9, 21, 34), s) for s in range(3)])
    got = extrema_cuda.extrema_mask_plain(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(extrema_mask_pallas(jnp.asarray(d), interpret=True)))


def _axis_writes(d, t, width, zruns=False):
    """Per position along one axis: how many threads of the launch own it
    (write its DoGs, and its zero mask outside the inside), and how many
    emit its mask from the neighbourhood test. Tiles of t emitted positions;
    tile k loads from k * t on, `width` positions in x and y and up to
    k * t + t + 1 in z (clipped); a position is owned by its tile's inside
    and the volume's first and last ones by the first and last tile
    (csrc/dogs_extrema.cu's own_xy and its own-plane rule). In x and y an
    owned inside position is emitted; in z a run emits the centre planes
    between its first and last loaded plane."""
    n = extrema_cuda.tiles(d, t)
    own = np.zeros(d, np.int64)
    emit = np.zeros(d, np.int64)
    for k in range(n):
        lo = k * t
        hi = min(lo + t + 1, d - 1) if zruns else lo + width - 1
        for p in range(lo, min(hi, d - 1) + 1):
            i = p - lo
            if (i >= 1 or k == 0) and (i <= t or k == n - 1):
                own[p] += 1
                if not zruns and 1 <= p <= d - 2:
                    emit[p] += 1
            if zruns and lo + 1 <= p <= hi - 1 and 1 <= p <= d - 2:
                emit[p] += 1
    return own, emit


def _octave_shapes(dims):
    shapes = []
    z, y, x = dims
    while z > 2 and y > 2 and x > 2:
        shapes.append((1, z, y, x))
        z, y, x = z // 2, y // 2, x // 2
    return shapes


GRID_SHAPES = sorted(set(
    _octave_shapes((182, 218, 182)) + _octave_shapes((364, 436, 364))
    + [(1, 94, 436, 364), (4, 94, 436, 364), (3, 37, 75, 61), (1, 3, 3, 3), (1, 1, 1, 1), (1, 4, 40, 70)]
))


@pytest.mark.parametrize("kernel", ["dogs_extrema", "extrema_mask"])
@pytest.mark.parametrize("shape", GRID_SHAPES, ids=str)
def test_launch_geometry_covers_every_voxel_once_and_fills_the_card(shape, kernel):
    b, z, y, x = shape
    g = extrema_cuda.extrema_launch_geometry(shape, kernel, n_sm=132)
    assert (g["ty"], g["zr"]) in extrema_cuda.LAUNCHES
    for d, t, lanes, zruns in ((x, extrema_cuda.TILE_X, extrema_cuda.LANES, False),
                               (y, g["ty"], g["ty"] + 2, False), (z, g["zr"], 0, True)):
        own, emit = _axis_writes(d, t, lanes, zruns)
        assert (own == 1).all(), (d, t, own)
        assert (emit[1:d - 1] == 1).all() and emit[0] == 0 and (d < 2 or emit[d - 1] == 0), (d, t)
    most = max(extrema_cuda.launch_blocks(shape, *l) for l in extrema_cuda.LAUNCHES)
    assert extrema_cuda.launch_blocks(shape, g["ty"], g["zr"]) >= min(2 * 132, most), (shape, g)
