"""Build and bind the port's hand-written CUDA kernels.

Every ``sift3d_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (Hopper), one process per file in parallel, and linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at the first CUDA call, never at import (the CPU tests import
every module, and the CPU has no ``nvcc``),
into ``sift3d_torch/_build/<hash>/``, keyed on a hash of the sources and
flags: a fresh checkout builds everything on first use, a changed source
rebuilds, and an unchanged one loads the existing library. Loading is
safe from several host threads at once (``dist.batch`` runs one per mesh
entry): one lock serializes :func:`library`, and every build writes its
objects into a temporary directory of its own before the library is
renamed into place.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on anything but 0 and counts
the entry's launches, which :func:`launches` reads.
``-fmad=false`` keeps every multiply and add separately rounded, in the
order the plain PyTorch versions compute them, so kernel and plain version
agree to the bit wherever their summation order agrees.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libsift3d_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures; every entry ends with (int device, void* stream)
SIGNATURES = {
    # g [B,6,Z,Y,X] f32, dogs [B,5,Z,Y,X] f32, mask [B,3,Z,Y,X] i8, B, Z, Y, X, ty, zr
    # (extrema_cuda.extrema_launch_geometry)
    "sift3d_dogs_extrema": (_P, _P, _P, _I, _I, _I, _I, _I, _I),
    # dogs [B,5,Z,Y,X] f32, mask [B,3,Z,Y,X] i8, B, Z, Y, X, ty, zr
    "sift3d_extrema_mask": (_P, _P, _I, _I, _I, _I, _I, _I),
    # cx, cy, cz, w [C,V], band [11,11], out [C,k,16], C, V, k
    "sift3d_hist_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I),
    # the fused canonical stage: pn [C,11,11,11], kvalid [C] bool (null: every row), band [11,11] f32 in
    # host memory, scratch p1 [C,K1,3] f32 and live [C,K1] bool, out ori [C,K1,K2,3,3] f32 and
    # ori_valid [C,K1,K2] bool, thr1, thr2, C, K1, K2
    "sift3d_canonical": (_P,) * 7 + (_F, _F, _I, _I, _I),
    # cx, cy, cz, w [C,V], band [11,11] (identity), hist [C,1331], C, V
    "sift3d_splat_histogram_raw": (_P, _P, _P, _P, _P, _P, _I, _I),
    # cx, cy, cz, w [C,V], band [11,11], hist [C,1331], pk [C,1331], C, V
    "sift3d_smooth_histogram_peaks": (_P, _P, _P, _P, _P, _P, _P, _I, _I),
    # gstack [L,Z,Y,X], lvl [R] i32, centers [R,3], scales [R], oris [R,3,3], out [R,1331], R, L,
    # Z, Y, X, z0 (global index of plane 0), depth (global Z)
    "sift3d_sample_rotated": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I),
    # in, out, tmp [B,Z,Y,X] f32, taps [2r+1] f32 and geom [6] i32 in host memory
    # (gauss_cuda.blur_launch_geometry), r, B, Z, Y, X
    "sift3d_blur3d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    # in [B,Z,Y,X] f32, out [B,OZ,OY,OX] f32 (resample_cuda.doubled_shape), B, Z, Y, X
    "sift3d_double_size": (_P, _P, _I, _I, _I, _I),
    # in [B,Z,Y,X] f32, out [B,OZ,OY,OX] f32, B, Z, Y, X, OZ, OY, OX, and each axis's dmin / d
    # as f32: fz, fy, fx (resample_cuda.isotropic_resample_batch)
    "sift3d_isotropic_resample": (_P, _P) + (_I,) * 7 + (_F, _F, _F),
    # gstack [B,L,Z,Y,X], dogs [B,ND,ZD,Y,X], lvl [R] i64, zyx [R,3] i64, vi [R] i64 (volume
    # index; null: B = 1), sigmas [ND] f32 in host memory; out xyz [R,3], scale [R], pn [R,1331],
    # eigs [R,3], ori [R,3,3], in_bounds [R] and eig_keep [R] bool; eig_threshold, R, B, L, Z, ND,
    # ZD, Y, X, gz0, dz0, depth
    "sift3d_identity_eig": (_P,) * 13 + (_F,) + (_I,) * 11,
    # gstack, lvl, centers, scales, oris [R,3,3], out [R,64] u8, R, L, Z, Y, X, z0, depth
    "sift3d_rotated_goh": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I),
    # patches [R,11,11,11], out [R,64] u8, R
    "sift3d_goh": (_P, _P, _I),
    # the fused BRIEF kernel: gstack, lvl, centers, scales, oris, pairs [2,64] i32 (flat voxel
    # indices), divisor [64] f32, taps [2r+1] f32 in host memory, r, variant (0 BRIEF, 1 RRIEF,
    # 2 NRRIEF), out [R,64] u8, R, L, Z, Y, X, z0, depth; on given patches [R,11,11,11]:
    # patches, pairs, divisor, taps, r, variant, out, R
    "sift3d_rotated_brief": (_P,) * 8 + (_I, _I, _P) + (_I,) * 7,
    "sift3d_brief": (_P, _P, _P, _P, _I, _I, _P, _I),
    # M1's f32 route: q [Q,C], db [N,C] f32, out dist [Q,k] f32, idx [Q,k] i64, Q, N, C, k
    "sift3d_knn_topk": (_P, _P, _P, _P, _I, _I, _I, _I),
    # M1's int8 route (knn_cuda.int8_plan): the pre-pass db [N,C] f32 -> db8 [Npad,64] i8,
    # dn [Npad] f32, tail [Npad,3] f32 (C = 67; null for 64), N, Npad, C; the main kernel q [Q,C],
    # db8, dn, tail, out dist [Q,k] f32, idx [Q,k] i64, part dist [S,Q,k] f32, part idx [S,Q,k]
    # i32, Q, N, C, k, S, slice_rows; the slices' merge part dist, part idx, dist, idx, Q, S, k
    "sift3d_knn_prep_i8": (_P, _P, _P, _P, _I, _I, _I),
    "sift3d_knn_topk_i8": (_P,) * 8 + (_I,) * 6,
    "sift3d_knn_merge": (_P, _P, _P, _P, _I, _I, _I),
    # the int8 main kernel's blocks an SM (occupancy API) for C, k, into an int in host memory
    "sift3d_knn_i8_blocks_per_sm": (_I, _I, _P),
    # M2's f32 route: q [Q,64], db [D,64], xyz [D,3], scale [D] f32, out idx [Q] i64, ratio [Q] f32,
    # Q, D, log_thr, shift; its int8 route: q, db8 [Dpad,64] i8 and dn [Dpad] f32 from
    # sift3d_knn_prep_i8, xyz, scale, idx, ratio, Q, D, log_thr, shift
    "sift3d_ratio_match": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F),
    "sift3d_ratio_match_i8": (_P,) * 7 + (_I, _I, _F, _F),
    # mode (0 scores, 1 inliers), p0 [M,3], p1 [M,3], s0 [M], s1 [M], o0 [M,9], o1 [M,9] f32 (each
    # match its hypothesis, formed in the kernel), offsets [P+1] i32, block offsets [P+1] i32
    # (hough.segment_blocks), winners [P] i32 (the three null for one pair), scores [M] i32
    # (zeroed), mask [M] u8, the winners' rotations and scales [P,10] f32, P, M, winner (one pair),
    # blocks, thres_scale, thres_trans, thres_orien
    "sift3d_hough": (_I,) + (_P,) * 12 + (_I, _I, _I, _I, _F, _F, _F),
}


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return it.

    Each source compiles in its own nvcc process, all started together,
    then one nvcc links them. Writes nvcc's report (ptxas registers /
    shared memory / spills per kernel) beside the library as ``nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # objects and the unlinked library in a directory of this call's own, so
    # that builds in other processes or threads never touch them
    work = pathlib.Path(tempfile.mkdtemp(prefix="build.", dir=out.parent))
    try:
        objs, procs = [], []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            text, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(text)
        tmp = work / LIB_NAME
        if not failed:
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log.append(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                failed.append(r.stderr)
        log.append(f"seconds: {time.perf_counter() - t0:.1f}\n")
        (out.parent / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(text[-4000:] for text in failed))
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# guards the library's load and the launch counts: kernels are launched
# from several host threads at once (dist.batch), and += 1 is a read and a
# write
_LOCK = threading.Lock()
_LAUNCHES = dict.fromkeys(SIGNATURES, 0)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; callable from any
    thread (the first caller builds, the others wait for it)."""
    with _LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args) + [_I, _P]
        fn.restype = _I
    return lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry `name` on `device`'s current stream, check the launch
    and count it (:func:`launches`). Tensors in args are passed as their
    data pointers. Every entry of SIGNATURES goes through here, the
    occupancy query ``sift3d_knn_i8_blocks_per_sm`` too, and is counted
    alike."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(library(), name)(*conv, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    with _LOCK:
        _LAUNCHES[name] += 1


def launches(name: str) -> int:
    """The launches of C entry `name` in this process so far: the count a
    run reads to show that it went through the kernel."""
    return _LAUNCHES[name]


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel argument: CUDA device, dtype, rank, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'kernel' for a CUDA tensor; raises else."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {t.device}")
