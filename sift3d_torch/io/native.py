"""ctypes bridge to the port's C++ ``.key`` text writer and reader
(``sift3d_torch/csrc/key_text.cpp``), the port's copy of
``sift3d.io.native``, and to its writer of featmatch's match files.

The library is built with g++ at first use, never at import, into
``sift3d_torch/_build/<hash>/`` keyed on a hash of the source and the flags
(as ``kernels.cuda_lib`` builds the kernels): a fresh checkout builds it, a
changed source rebuilds, an unchanged one loads the existing library. A
failed build raises with the compiler's message; the pure-Python writer and
reader in ``sift3d_torch.io.keyfile`` are the plain version, which callers
select with ``use_native=False``, never a silent fallback.

Safe from several host threads at once (``dist.batch`` runs one per mesh
entry): one lock serializes :func:`load`, a build writes into a temporary
directory of its own before the library is renamed into place, and the C
entries keep no state between calls (ctypes releases the interpreter lock
while they run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

from sift3d_torch.core.featureset import DESCRIPTOR_SIZE, FeatureSet

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "key_text.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libsift3d_torch_keytext.so"
# -ffp-contract=off: the write-time eigenvalue filter rounds each product on
# its own, as FeatureSet.eig_mask does (csrc/key_text.cpp)
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-ffp-contract=off")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return it.
    Writes g++'s output and the build's seconds beside it as ``g++.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native .key I/O is built with g++")
    t0 = time.perf_counter()
    work = pathlib.Path(tempfile.mkdtemp(prefix="build.", dir=out.parent))
    try:
        tmp = work / LIB_NAME
        cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (out.parent / "g++.log").write_text(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}seconds: {seconds:.3f}\n")
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def build_seconds() -> Optional[float]:
    """The seconds g++ took to build the current library (from its log), or
    None when it has not been built."""
    log = library_path().parent / "g++.log"
    if not log.exists():
        return None
    for line in log.read_text().splitlines():
        if line.startswith("seconds: "):
            return float(line.split()[1])
    return None


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; callable from any thread (the
    first caller builds, the others wait for it)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            lib.s3d_write_key_text.restype = ctypes.c_int
            lib.s3d_write_key_text.argtypes = [
                ctypes.c_char_p, ctypes.c_int, f32, f32, f32, f32, u32, f32,
                ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_float,
            ]
            lib.s3d_key_count.restype = ctypes.c_int
            lib.s3d_key_count.argtypes = [ctypes.c_char_p]
            lib.s3d_read_key_text.restype = ctypes.c_int
            lib.s3d_read_key_text.argtypes = [ctypes.c_char_p, ctypes.c_int, f32, f32, f32, f32, u32, f32]
            lib.s3d_write_match_text.restype = ctypes.c_int
            lib.s3d_write_match_text.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, f32, f32, f32,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ]
            _LIB = lib
        return _LIB


def write_key_text(feats: FeatureSet, path, eig_threshold: float, comments: Optional[Sequence[str]]) -> int:
    """Write ``feats`` as a .key text file; returns the rows written after
    the eigenvalue filter (``eig_threshold`` < 0 keeps all)."""
    lib = load()
    encoded = [c.encode() for c in (comments or [])]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    n = len(feats)
    written = lib.s3d_write_key_text(
        os.fsencode(path), n,
        np.ascontiguousarray(feats.xyz, np.float32),
        np.ascontiguousarray(feats.scale, np.float32),
        np.ascontiguousarray(np.reshape(feats.ori, (n, 9)), np.float32),
        np.ascontiguousarray(feats.eigs, np.float32),
        np.ascontiguousarray(feats.info, np.uint32),
        np.ascontiguousarray(feats.desc, np.float32),
        len(encoded), arr, ctypes.c_float(eig_threshold),
    )
    if written < 0:
        raise OSError(f"{path}: cannot open for writing")
    return int(written)


def read_key_text(path) -> FeatureSet:
    """The rows of a .key text file: at most its declared count, stopping at
    the first row that does not parse (csrc/key_text.cpp)."""
    lib = load()
    name = os.fsencode(path)
    n = int(lib.s3d_key_count(name))
    if n < 0:
        raise ValueError(f"{path}: not a .key text file")
    xyz = np.zeros((n, 3), np.float32)
    scale = np.zeros(n, np.float32)
    ori = np.zeros((n, 9), np.float32)
    eigs = np.zeros((n, 3), np.float32)
    info = np.zeros(n, np.uint32)
    desc = np.zeros((n, DESCRIPTOR_SIZE), np.float32)
    rows = int(lib.s3d_read_key_text(name, n, xyz, scale, ori, eigs, info, desc))
    if rows < 0:
        raise ValueError(f"{path}: parse failure")
    return FeatureSet(
        xyz=xyz[:rows], scale=scale[:rows], ori=ori[:rows].reshape(-1, 3, 3),
        eigs=eigs[:rows], info=info[:rows], desc=desc[:rows],
    )


def write_match_text(path, header: str, name: str, xyz, scale, ori, other) -> int:
    """Write one featmatch match file: ``header``, then one line per match m
    of the rows xyz [n, 3], scale [n], ori [n, 3, 3] with the other image's
    row other[m] (csrc/key_text.cpp, s3d_write_match_text)."""
    lib = load()
    n = len(scale)
    written = lib.s3d_write_match_text(
        os.fsencode(path), header.encode(), name.encode(), n,
        np.ascontiguousarray(xyz, np.float32), np.ascontiguousarray(scale, np.float32),
        np.ascontiguousarray(np.reshape(ori, (n, 9)), np.float32), np.ascontiguousarray(other, np.int64),
    )
    if written < 0:
        raise OSError(f"{path}: cannot open for writing")
    return int(written)
