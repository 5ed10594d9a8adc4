"""PyTorch port end to end against the JAX package on the CPU at full size:
the T1 cell, ``synthetic_blob_texture((182, 218, 182), seed=7)`` (the
volume of bench.py), GoH descriptors.

- The port's own extraction and the JAX package's give the same count,
  repeatability >= 0.995 both ways and equal ``info``. (The pyramids part
  by XLA's per-shape blur order, test_torch_extract_48.py, which moves
  locations by up to about 0.02 voxel.)
- Fed JAX's compiled pyramid (``_phase1_program``, as
  test_torch_extract_48.py does), locations, scales and flags are exact.
- Every fed-pyramid row whose orientation or an eigenvalue lies more than
  1e-5 from JAX's (orientation entries absolute, eigenvalues relative) is
  attributed. The identity patches of the two stages differ in the last
  bit (ROADMAP Queue 3, classified), and the rows above 1e-5 are where the
  math amplifies that or f32 rounding:
  - an eigenvalue row, or an unoriented row (its orientation is the
    structure tensor's eigenvectors): the f64 replay of
    test_torch_gather_eig.py (``_f64_kappa``) gives kappa > 32; or the f64
    eigenvectors of the port's own patch lie within 16 * 2^-24 * kappa of
    the port's (a backward-stable f32 solver's accuracy: the port is
    right to f32, and the rest is JAX's solver and the patch gap);
  - a reoriented row (its orientation is the canonical frame of two
    orientation histograms): an f64 replay of the canonical stage on the
    port's patch (gradients, the 11^3 splat and blur, peaks, quadratic
    vertices, Gram-Schmidt) gives a frame within 1e-5 of the port's; or
    one no nearer than the f64 replay on JAX's patch is (the histogram
    peak amplifies the patches' last-bit gap at least as much as the
    port's own rounding); or a peak of the frame's histograms within
    f32 reassociation (V * 2^-24 of its value, V splat points) of a
    tie with a neighbouring bin or of the 0.8 / 0.5 thresholds.
  And fed JAX's own patches, the port's canonical stage gives JAX's
  frames bit for bit.

On this cell (the same before and after the switch from the double-rounded
multiply-add to ``numerics.fma_exact``, which changes no bit here): 37 rows
above 1e-5 in orientation (31 unoriented, 6 reoriented), 7 above 1e-4, the
largest 3.25e-3; 24 rows with an eigenvalue above 1e-5. All 24 eigenvalue
rows and 30 of the unoriented rows have kappa > 32; the last unoriented
row (kappa 28.8) is 1.05e-5 from the f64 eigenvectors, inside its bound of
2.7e-5; 4 reoriented rows lie within 1e-5 of the f64 frame, one within the
spread of the f64 frames of the two patches (1.5e-5 against 1.2e-4), and
the 3.25e-3 row's secondary peak ties its z neighbour in the f64 histogram
to 2.9e-6 of its value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d.core.config import SiftConfig as JxConfig
from sift3d.pipeline import features as jx_features
from sift3d.pipeline.extract import extract_features as jx_extract
from sift3d_torch.core.config import SiftConfig
from sift3d_torch.core.featureset import INFO_FLAG_REORIENT
from sift3d_torch.kernels.gauss import gaussian_kernel_1d
from sift3d_torch.kernels.hist_cuda import hist_band
from sift3d_torch.kernels.patch import sphere_mask
from sift3d_torch.pipeline import features, pyramid
from sift3d_torch.pipeline.extract import extract_features
from sift3d_torch.utils.synthetic import repeatability, synthetic_blob_texture

from test_torch_extract_48 import _jax_octaves
from test_torch_gather_eig import KAPPA_MAX, _f64_kappa

torch.set_num_threads(1)
T1 = (182, 218, 182)
CFG = SiftConfig()
SIGMAS = tuple(CFG.level_sigmas())
U = 2.0**-24
P, RAD = 11, 5.0
SPHERE = np.nonzero(sphere_mask().ravel())[0]
REASSOC = len(SPHERE) * U  # relative error bound of an f32 sum of the V splat points
BAND = hist_band(gaussian_kernel_1d(CFG.ori_hist_blur_sigma, 0.01)).astype(np.float64)


@pytest.fixture(scope="module")
def t1():
    """The three extractions, and for every fed-pyramid row its candidate's
    normalized patch from the port's stage and from the JAX package's."""
    vol = synthetic_blob_texture(T1, seed=7)
    want = jx_extract(vol, JxConfig())
    own = extract_features(vol, device="cpu")
    octaves = _jax_octaves(vol)
    caps, feed, octave = [], iter(octaves), [-1]
    gather_eig = features.gather_eig

    def octave_core(base, cfg):
        octave[0] += 1
        return (*(t[None] for t in next(feed)), base)

    def capture(gstack, dogs, lvl, zyx, *args, **kwargs):
        out = gather_eig(gstack, dogs, lvl, zyx, *args, **kwargs)
        caps.append((octave[0], lvl, zyx, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "initial_blur_core", lambda img, cfg, initial_image_scale=1.0: img)
        mp.setattr(pyramid, "octave_core", octave_core)
        mp.setattr(features, "gather_eig", capture)
        got = extract_features(vol, device="cpu")

    # each row's candidate (octave, index among the kept rows), found by its
    # location and scale in image geometry
    where, kept_pn = {}, {}
    for o, lvl, zyx, (xyz, scale, inb, pn, _, _, keep) in caps:
        kept = (inb & keep).numpy()
        kept_pn[o] = pn.numpy()[kept]
        f = np.float32(2.0**o)
        for i, (x, s) in enumerate(zip(xyz.numpy()[kept] * f, scale.numpy()[kept] * f)):
            where[(x.tobytes(), s.tobytes())] = (o, i)
    cand = [where[(x.tobytes(), s.tobytes())] for x, s in zip(got.xyz, got.scale)]
    # the JAX package's patches of the octaves that hold a row the tests
    # below read: those more than 1e-5 apart and the first 64
    d_ori = np.abs(got.ori - want.ori).reshape(len(got), -1).max(axis=1)
    d_eig = (np.abs(got.eigs - want.eigs) > 1e-5 * np.abs(want.eigs)).any(axis=1)
    rows = np.union1d(np.nonzero((d_ori > 1e-5) | d_eig)[0], np.arange(64))
    jax_pn = {}
    for o, lvl, zyx, (_, _, inb, _, _, _, keep) in caps:
        if o not in {cand[r][0] for r in rows}:
            continue
        gstack, dogs, _ = octaves[o]
        patches = jx_features.gather_stage(
            jnp.asarray(gstack.numpy()), jnp.asarray(dogs.numpy()), jnp.asarray(lvl.numpy().astype(np.int32)),
            jnp.asarray(zyx.numpy().astype(np.int32)), jnp.ones(lvl.shape[0], bool), SIGMAS,
        )[3]
        jax_pn[o] = np.asarray(jx_features.eig_stage(patches, JxConfig())[0])[(inb & keep).numpy()]
    return dict(want=want, own=own, got=got, d_ori=d_ori, d_eig=d_eig, rows=rows,
                pn_t={r: kept_pn[cand[r][0]][cand[r][1]] for r in rows},
                pn_j={r: jax_pn[cand[r][0]][cand[r][1]] for r in rows})


def test_t1_own_pyramid_matches_jax(t1):
    want, own = t1["want"], t1["own"]
    rep = (repeatability(own, want)[0], repeatability(want, own)[0])
    print(f"own pyramid: jax {len(want)} features, port {len(own)}, repeatability {rep}")
    assert len(own) == len(want) > 500
    assert min(rep) >= 0.995
    np.testing.assert_array_equal(own.info, want.info)


def test_t1_fed_pyramid_geometry_is_exact(t1):
    want, got = t1["want"], t1["got"]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(got.info, want.info)
    desc_eq = (got.desc == want.desc).all(axis=1).mean()
    print(f"fed pyramid: identical descriptors {desc_eq:.4f}")
    assert desc_eq >= 0.99


def _gradients64(pn):
    """Central differences of one patch in f64, zero border: [3 (x, y, z), V]
    over the sphere voxels."""
    p = pn.astype(np.float64)
    g = np.zeros((3,) + p.shape)
    c = (slice(1, -1),) * 3
    g[0][c] = p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]
    g[1][c] = p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]
    g[2][c] = p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]
    return g.reshape(3, -1)[:, SPHERE]


def _unit(v):
    n = np.linalg.norm(v, axis=0)
    return v / np.where(n > 0, n, 1.0)


def _axis_factors(u):
    """[V, 11] splat-then-blur weights of bin coordinates u (hist_cuda's)."""
    i0 = np.clip(np.floor(u).astype(np.int64), 0, P - 2)
    w0 = np.where(u < 0, 1.0, np.where(u >= P - 1, 0.0, 1.0 - (u - i0)))
    return w0[:, None] * BAND[i0] + (1.0 - w0)[:, None] * BAND[i0 + 1]


def _peaks64(e, w, k, threshold):
    """The f64 blurred histogram of unit directions e [3, V] weighted by w;
    returns its k largest strict interior peaks that pass the threshold as
    (vertex (x, y, z), margin): margin is the smallest relative distance of
    the peak's value to a 26-neighbour's or to threshold * the top peak."""
    h = np.einsum("v,vz,vy,vx->zyx", w, *(_axis_factors(e[i] * RAD + RAD) for i in (2, 1, 0)))
    pad = np.pad(h, 1, constant_values=-np.inf)
    shifts = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dz or dy or dx]
    nb = np.stack([pad[1 + dz : 1 + dz + P, 1 + dy : 1 + dy + P, 1 + dx : 1 + dx + P] for dz, dy, dx in shifts])
    peak = (h > nb).all(axis=0)
    peak[[0, -1]] = peak[:, [0, -1]] = peak[:, :, [0, -1]] = False
    idx = np.nonzero(peak.ravel())[0]
    idx = idx[np.argsort(-h.ravel()[idx], kind="stable")][:k]
    top = h.ravel()[idx[0]] if len(idx) else 0.0
    out = []
    for j in idx:
        z, y, x = np.unravel_index(j, h.shape)
        v = h[z, y, x]
        if not (v >= threshold * top and v > 0):
            continue

        def vertex(lo, hi, c):
            den = lo - 2 * v + hi
            return c + (0.5 * (lo - hi) / den if den != 0 else 0.0)

        itp = np.array([vertex(h[z, y, x - 1], h[z, y, x + 1], x), vertex(h[z, y - 1, x], h[z, y + 1, x], y),
                        vertex(h[z - 1, y, x], h[z + 1, y, x], z)])
        margin = min((v - nb[:, z, y, x].max()) / v, abs(v - threshold * top) / v)
        out.append((itp, margin))
    return out


def _frames64(pn):
    """The f64 replay of the canonical stage on one normalized patch: every
    (frame [3, 3] with rows p1, p2, p1 x p2, the smaller margin of its
    primary and secondary peaks)."""
    g = _gradients64(pn)
    w, e = np.linalg.norm(g, axis=0), _unit(g)
    out = []
    for itp1, m1 in _peaks64(e, w, CFG.max_primary_orientations, CFG.ori_peak_threshold):
        p1 = _unit((itp1 - RAD)[:, None])[:, 0]
        perp = _unit(e - (p1 @ e)[None] * p1[:, None])
        for itp2, m2 in _peaks64(perp, w, CFG.max_secondary_orientations, CFG.ori_2nd_peak_threshold):
            p2 = _unit((itp2 - RAD)[:, None])[:, 0]
            p2 = _unit((p2 - (p2 @ p1) * p1)[:, None])[:, 0]
            out.append((np.stack([p1, p2, np.cross(p1, p2)]), min(m1, m2)))
    return out


def _closest_frame(pn, ori):
    """(distance, margin, frame) of the f64 frame of pn nearest the f32
    frame ori."""
    return min(((np.abs(f - ori).max(), m, f) for f, m in _frames64(pn)), key=lambda t: t[0])


def _eigvec_error(pn, ori):
    """Largest entry distance of the eigenvector columns of ori (descending
    eigenvalues) from the f64 eigenvectors of pn's structure tensor, each up
    to its sign."""
    f = _gradients64(pn) * sphere_mask().ravel()[SPHERE]
    _, vec = np.linalg.eigh(f @ f.T)
    vec = vec[:, ::-1]
    return max(min(np.abs(ori[:, k] - vec[:, k]).max(), np.abs(ori[:, k] + vec[:, k]).max()) for k in range(3))


def test_t1_fed_pyramid_rows_are_attributed(t1):
    want, got, pn_t, pn_j, d_ori, d_eig = (t1[k] for k in ("want", "got", "pn_t", "pn_j", "d_ori", "d_eig"))
    reo = (got.info & INFO_FLAG_REORIENT) != 0
    flagged = np.nonzero((d_ori > 1e-5) | d_eig)[0]
    kappa = dict(zip(flagged, _f64_kappa(np.stack([pn_t[r] for r in flagged]))))
    print(f"orientation > 1e-5: {(d_ori > 1e-5).sum()} rows ({(~reo & (d_ori > 1e-5)).sum()} unoriented), "
          f"> 1e-4: {(d_ori > 1e-4).sum()}, largest {d_ori.max():.3g}; eigenvalues > 1e-5: {d_eig.sum()}")
    unexplained = []
    for r in flagged:
        ill = kappa[r] > KAPPA_MAX
        if d_eig[r] and not ill:
            unexplained.append((r, "eigenvalues", kappa[r]))
        if d_ori[r] <= 1e-5:
            continue
        if not reo[r]:
            err = _eigvec_error(pn_t[r], got.ori[r])
            why = "kappa" if ill else "eigenvectors" if err <= 16 * U * kappa[r] else None
            print(f"row {r}: unoriented, {d_ori[r]:.3g} apart, kappa {kappa[r]:.1f}, f64 eigenvectors {err:.3g}: {why}")
        else:
            dist, margin, frame = _closest_frame(pn_t[r], got.ori[r])
            spread = np.abs(frame - _closest_frame(pn_j[r], want.ori[r])[2]).max()
            why = ("f64 frame" if dist <= 1e-5 else "patch gap" if dist <= spread
                   else "tie or threshold" if margin <= REASSOC else None)
            print(f"row {r}: reoriented, {d_ori[r]:.3g} apart, f64 frame {dist:.3g}, f64 spread {spread:.3g}, "
                  f"peak margin {margin:.3g}: {why}")
        if why is None:
            unexplained.append((r, "orientation", d_ori[r]))
    assert not unexplained
    # and held as test_torch_gather_eig.py holds its ill-conditioned rows:
    # eigenvalues within 1e-5 of the row's largest, eigenvectors within 1e-3
    big = np.abs(want.eigs).max(axis=1, keepdims=True)
    assert (np.abs(got.eigs - want.eigs) <= 1e-5 * big).all()
    assert d_ori[~reo].max() <= 1e-3


def test_t1_canonical_stage_on_jax_patches_is_jax(t1):
    """Fed the JAX package's own patches, the port's canonical stage gives
    JAX's frames and slots bit for bit, on the candidates of every row more
    than 1e-5 from JAX's and of the first 64 rows."""
    rows = t1["rows"]
    pn = np.stack([t1["pn_j"][r] for r in rows])
    port = features.canonical_stage(torch.from_numpy(pn), CFG)
    jax = jx_features.canonical_stage(jnp.asarray(pn), JxConfig())
    np.testing.assert_array_equal(port["ori_valid"].numpy(), np.asarray(jax["ori_valid"]))
    valid = port["ori_valid"].numpy()
    np.testing.assert_array_equal(port["ori"].numpy()[valid], np.asarray(jax["ori"])[valid])
