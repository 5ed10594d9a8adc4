"""Seeded groups of .key feature sets for the matching cells.

Made by the benchmark from the seed, not by the port's extraction, so the
reference never has to extract anything. Set 0 is a base set of n rows,
all reoriented features (info flag 0x20), located inside the grid, with
scales spread over the pyramid's octaves, random rotation frames (rows are
the frame's axes, as the port stores them) and eigenvalues that pass the
edge test. Its descriptors are GoH-like rows as the port's .key writer
prints them: the ranks 0..63 of a latent 64-vector. Sets 1..count-1 are
copies under their own seeded similarity (a rotation of up to max_rot_deg
about a random axis, a scale in [scale_lo, scale_hi], a shift of up to
max_shift voxels, all about the grid's centre), with location, scale,
orientation and descriptor noise, and a share of their rows replaced by
fresh random features. The pattern follows ``chip_smoke.similarity_matches``.

Every float is written with C's "%f" (six decimals), which any strtof-
exact reader reads back as the f32 nearest the decimal, so the program's
reader and the reference's parser see the same values.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

INFO_MIN0MAX1 = 0x10
INFO_REORIENT = 0x20
LEGEND = (
    "Scale-space location[x y z scale] orientation[o11 o12 o13 o21 o22 o23 o31 o32 o32] "
    "2nd moment eigenvalues[e1 e2 e3] info flag[i1] descriptor[d1 .. d64]"
)
_ROW = "%f\t" * 16 + "%d\t" * 65


def rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """n random rotation matrices [n, 3, 3] (QR of Gaussian matrices)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def axis_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    a = axis / np.linalg.norm(axis)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def ranks(latent: np.ndarray) -> np.ndarray:
    """Each row's ranks 0..63 (the rank-normalized GoH row's form)."""
    return np.argsort(np.argsort(latent, axis=1, kind="stable"), axis=1, kind="stable")


def _features(rng: np.random.Generator, n: int, dims_zyx: Sequence[int], octaves: int) -> dict:
    """n fresh random features: geometry in the grid, frames, eigenvalues,
    info and a latent descriptor vector."""
    extent = np.asarray(dims_zyx[::-1], np.float64)  # x, y, z
    margin = 0.1 * extent
    lam = rng.uniform(0.5, 50.0, (n, 1))
    return dict(
        xyz=margin + rng.uniform(0, 1, (n, 3)) * (extent - 2 * margin),
        scale=1.6 * 2.0 ** rng.uniform(0.0, octaves, n),
        ori=rotations(rng, n),
        eigs=lam * np.concatenate([np.ones((n, 1)), rng.uniform(0.6, 1.0, (n, 2))], axis=1),
        info=INFO_REORIENT | np.where(rng.uniform(0, 1, n) < 0.5, INFO_MIN0MAX1, 0),
        latent=rng.standard_normal((n, 64)),
    )


def group(seed: int, params: dict, dims_zyx: Sequence[int], octaves: int) -> List[dict]:
    """The group's `count` sets as dicts of arrays (xyz, scale, ori, eigs,
    info, desc) plus, for the copies, their similarity (rot, scale, shift)."""
    p = params
    base = _features(np.random.default_rng((int(seed), 0)), p["rows"], dims_zyx, octaves)
    center = np.asarray(dims_zyx[::-1], np.float64) / 2
    sets = [dict(base, desc=ranks(base["latent"]))]
    for i in range(1, p["count"]):
        rng = np.random.default_rng((int(seed), i))
        rot = axis_rotation(rng.standard_normal(3), np.deg2rad(rng.uniform(0, p["max_rot_deg"])))
        s = rng.uniform(p["scale_lo"], p["scale_hi"])
        d = rng.standard_normal(3)
        shift = d / np.linalg.norm(d) * rng.uniform(0, p["max_shift"])
        n = p["rows"]
        c = dict(
            xyz=s * (base["xyz"] - center) @ rot.T + center + shift + rng.normal(0, p["loc_noise"], (n, 3)),
            scale=s * base["scale"] * np.exp(rng.normal(0, p["scale_noise"], n)),
            ori=base["ori"] @ rot.T + rng.normal(0, p["ori_noise"], (n, 3, 3)),
            eigs=base["eigs"] * np.exp(rng.normal(0, 0.05, (n, 3))),
            info=base["info"].copy(),
            latent=base["latent"] + rng.normal(0, p["desc_noise"], (n, 64)),
        )
        fresh = _features(rng, n, dims_zyx, octaves)
        swap = rng.permutation(n)[: int(round(n * p["replaced"]))]
        for k in c:
            c[k][swap] = fresh[k][swap]
        c["desc"] = ranks(c["latent"])
        c["similarity"] = dict(rot=rot, scale=s, shift=shift)
        sets.append(c)
    return sets


def key_text(fs: dict) -> str:
    """A set as .key text, as the port's writer lays it out."""
    vals = np.concatenate([fs["xyz"], fs["scale"][:, None], fs["ori"].reshape(-1, 9), fs["eigs"]], axis=1)
    vals = vals.astype(np.float32).astype(np.float64).tolist()
    ints = np.concatenate([fs["info"][:, None], fs["desc"]], axis=1).astype(np.int64).tolist()
    head = ["# featExtract 1.1", f"Features: {len(vals)}", LEGEND]
    return "\n".join(head + [_ROW % (*v, *i) for v, i in zip(vals, ints)]) + "\n"


def write_group(sets: List[dict], directory: str) -> List[str]:
    """Write each set as <directory>/set_<i>.key; returns the paths."""
    paths = []
    for i, fs in enumerate(sets):
        path = os.path.join(directory, f"set_{i:02d}.key")
        with open(path, "wt") as f:
            f.write(key_text(fs))
        paths.append(path)
    return paths
