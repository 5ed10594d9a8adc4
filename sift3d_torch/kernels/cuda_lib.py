"""Build and bind the port's hand-written CUDA kernels.

Every ``sift3d_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into ONE shared library with a plain C interface,
loaded with ``ctypes``. The build happens at the first CUDA call, never at
import (the CPU tests import every module, and the CPU has no ``nvcc``),
into ``sift3d_torch/_build/<hash>/``, keyed on a hash of the sources and
flags: a fresh checkout builds everything on first use, a changed source
rebuilds, and an unchanged one loads the existing library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on anything but 0.
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
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libsift3d_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures; every entry ends with (int device, void* stream)
SIGNATURES = {
    # g [6,Z,Y,X] f32, dogs [5,Z,Y,X] f32, mask [3,Z,Y,X] i8, Z, Y, X
    "sift3d_dogs_extrema": (_P, _P, _P, _I, _I, _I),
    # gstack [L,Z,Y,X], lvl [R] i32, centers [R,3], scales [R], out [R,1331], R, L, Z, Y, X
    "sift3d_sample_identity": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    # cx, cy, cz, w [C,V], band [11,11], out [C,k,16], C, V, k
    "sift3d_hist_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I),
    # gstack, lvl, centers, scales, oris [R,3,3], out [R,1331], R, L, Z, Y, X
    "sift3d_sample_rotated": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
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

    Writes nvcc's report (ptxas registers / shared memory / spills per
    kernel) beside the library as ``nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}\nseconds: {time.perf_counter() - t0:.1f}\n"
    (out.parent / "nvcc.log").write_text(log)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args) + [_I, _P]
        fn.restype = _I
    return lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry `name` on `device`'s current stream and check the
    launch. Tensors in args are passed as their data pointers."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(library(), name)(*conv, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


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
