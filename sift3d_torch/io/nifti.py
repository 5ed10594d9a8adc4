"""Pure-Python NIfTI-1 reader/writer (numpy only).

The PyTorch port's copy of ``sift3d.io.nifti``: importing anything under
``sift3d`` pulls in JAX, which the port never imports. It replaces the
reference's vendored C reader
(cuda_common/nifti1_io.c, 7509 LoC): we implement the consumer subset the
pipeline actually uses — .nii / .nii.gz / .hdr+.img (Analyze) reading with
datatype conversion to float32 (featExtract.cpp:18-77 reg_changeDatatype),
qform/sform voxel-to-world matrices (nifti1_io.c nifti_quatern_to_mat44),
and a writer for test fixtures and transformed outputs.

Header layout follows the NIfTI-1 standard (cuda_common/nifti1.h).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

# NIfTI-1 datatype codes (cuda_common/nifti1.h)
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


@dataclasses.dataclass
class NiftiImage:
    """Decoded NIfTI volume: data in [Z, Y, X] (+ optional T leading) order."""

    data: np.ndarray  # [Z, Y, X] float-convertible
    voxel_size: Tuple[float, float, float]  # (dx, dy, dz)
    qform_code: int
    sform_code: int
    qto_xyz: np.ndarray  # 4x4
    sto_xyz: Optional[np.ndarray]  # 4x4 or None

    @property
    def dims_xyz(self) -> Tuple[int, int, int]:
        z, y, x = self.data.shape[-3:]
        return (x, y, z)

    def world_matrix(self, use_sform: bool = False) -> np.ndarray:
        """Voxel-to-world 4x4 (qform by default; sform when requested and
        valid), as ``sift3d.core.volume.Volume.world_matrix``: `-ws`
        prefers sto_xyz when sform_code > 0, else falls back to qto_xyz
        (featExtract.cpp:447-458)."""
        if use_sform and self.sform_code > 0 and self.sto_xyz is not None:
            return np.asarray(self.sto_xyz, dtype=np.float64)
        if self.qto_xyz is not None:
            return np.asarray(self.qto_xyz, dtype=np.float64)
        m = np.eye(4, dtype=np.float64)
        m[0, 0], m[1, 1], m[2, 2] = self.voxel_size
        return m


def _quatern_to_mat44(b, c, d, qx, qy, qz, dx, dy, dz, qfac) -> np.ndarray:
    """nifti_quatern_to_mat44 (nifti1_io.c): quaternion + scalings -> 4x4."""
    a = 1.0 - (b * b + c * c + d * d)
    if a < 1.0e-7:
        # special case: 180-degree rotation
        a = 1.0 / np.sqrt(b * b + c * c + d * d)
        b *= a
        c *= a
        d *= a
        a = 0.0
    else:
        a = np.sqrt(a)
    xd = dx if dx > 0 else 1.0
    yd = dy if dy > 0 else 1.0
    zd = dz if dz > 0 else 1.0
    if qfac < 0:
        zd = -zd
    m = np.eye(4)
    m[0, 0] = (a * a + b * b - c * c - d * d) * xd
    m[0, 1] = 2.0 * (b * c - a * d) * yd
    m[0, 2] = 2.0 * (b * d + a * c) * zd
    m[1, 0] = 2.0 * (b * c + a * d) * xd
    m[1, 1] = (a * a + c * c - b * b - d * d) * yd
    m[1, 2] = 2.0 * (c * d - a * b) * zd
    m[2, 0] = 2.0 * (b * d - a * c) * xd
    m[2, 1] = 2.0 * (c * d + a * b) * yd
    m[2, 2] = (a * a + d * d - c * c - b * b) * zd
    m[0, 3], m[1, 3], m[2, 3] = qx, qy, qz
    return m


def mat44_to_quatern(m: np.ndarray):
    """nifti_mat44_to_quatern: 4x4 -> (b, c, d, qx, qy, qz, dx, dy, dz, qfac)."""
    r = np.array(m[:3, :3], dtype=np.float64)
    qx, qy, qz = m[0, 3], m[1, 3], m[2, 3]
    d1 = np.linalg.norm(r[:, 0])
    d2 = np.linalg.norm(r[:, 1])
    d3 = np.linalg.norm(r[:, 2])
    r[:, 0] /= d1
    r[:, 1] /= d2
    r[:, 2] /= d3
    qfac = 1.0
    if np.linalg.det(r) < 0:
        qfac = -1.0
        r[:, 2] = -r[:, 2]
    # orthogonalize via SVD (nifti uses a polar decomposition)
    u, _, vt = np.linalg.svd(r)
    r = u @ vt
    a = r[0, 0] + r[1, 1] + r[2, 2] + 1.0
    if a > 0.5:
        a = 0.5 * np.sqrt(a)
        b = 0.25 * (r[2, 1] - r[1, 2]) / a
        c = 0.25 * (r[0, 2] - r[2, 0]) / a
        d = 0.25 * (r[1, 0] - r[0, 1]) / a
    else:
        xd = 1.0 + r[0, 0] - (r[1, 1] + r[2, 2])
        yd = 1.0 + r[1, 1] - (r[0, 0] + r[2, 2])
        zd = 1.0 + r[2, 2] - (r[0, 0] + r[1, 1])
        if xd > 1.0:
            b = 0.5 * np.sqrt(xd)
            c = 0.25 * (r[0, 1] + r[1, 0]) / b
            d = 0.25 * (r[0, 2] + r[2, 0]) / b
            a = 0.25 * (r[2, 1] - r[1, 2]) / b
        elif yd > 1.0:
            c = 0.5 * np.sqrt(yd)
            b = 0.25 * (r[0, 1] + r[1, 0]) / c
            d = 0.25 * (r[1, 2] + r[2, 1]) / c
            a = 0.25 * (r[0, 2] - r[2, 0]) / c
        else:
            d = 0.5 * np.sqrt(zd)
            b = 0.25 * (r[0, 2] + r[2, 0]) / d
            c = 0.25 * (r[1, 2] + r[2, 1]) / d
            a = 0.25 * (r[1, 0] - r[0, 1]) / d
        if a < 0.0:
            a, b, c, d = -a, -b, -c, -d
    return b, c, d, qx, qy, qz, d1, d2, d3, qfac


def _open_maybe_gz(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _resolve_pair(path: str) -> Tuple[str, Optional[str]]:
    """Return (header path, data path or None for single-file .nii)."""
    lower = path.lower()
    if lower.endswith((".nii", ".nii.gz")):
        return path, None
    for hdr_ext, img_exts in ((".hdr", (".img", ".img.gz")), (".hdr.gz", (".img.gz", ".img"))):
        if lower.endswith(hdr_ext):
            base = path[: -len(hdr_ext)]
            for ie in img_exts:
                if os.path.exists(base + ie):
                    return path, base + ie
            raise FileNotFoundError(f"no .img file for {path}")
    # default: treat as single-file nifti
    return path, None


def read(path: str) -> NiftiImage:
    hdr_path, img_path = _resolve_pair(path)
    with _open_maybe_gz(hdr_path) as f:
        raw = f.read(_HDR_SIZE)
        if len(raw) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        endian = "<"
        (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
        if sizeof_hdr != _HDR_SIZE:
            endian = ">"
            (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
            if sizeof_hdr != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1/Analyze file")
        dim = struct.unpack(endian + "8h", raw[40:56])
        datatype, bitpix = struct.unpack(endian + "2h", raw[70:74])
        pixdim = struct.unpack(endian + "8f", raw[76:108])
        (vox_offset,) = struct.unpack(endian + "f", raw[108:112])
        qform_code, sform_code = struct.unpack(endian + "2h", raw[252:256])
        quatern = struct.unpack(endian + "6f", raw[256:280])
        srow = struct.unpack(endian + "12f", raw[280:328])
        magic = raw[344:348]

        ndim = max(1, dim[0])
        nx = max(1, dim[1])
        ny = max(1, dim[2]) if ndim >= 2 else 1
        nz = max(1, dim[3]) if ndim >= 3 else 1
        nt = max(1, dim[4]) if ndim >= 4 else 1
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype code {datatype}")
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        count = nx * ny * nz * nt
        nbytes = count * np_dtype.itemsize

        single_file = magic[:3] == b"n+1" or img_path is None
        if single_file and img_path is None:
            offset = int(vox_offset) if vox_offset >= _HDR_SIZE else _HDR_SIZE + 4
            f.read(offset - _HDR_SIZE)
            buf = f.read(nbytes)
        else:
            buf = b""
    if img_path is not None:
        with _open_maybe_gz(img_path) as fi:
            fi.read(int(vox_offset)) if vox_offset > 0 else None
            buf = fi.read(nbytes)
    if len(buf) < nbytes:
        raise ValueError(f"{path}: truncated voxel data ({len(buf)} < {nbytes})")

    arr = np.frombuffer(buf, dtype=np_dtype, count=count)
    # NIfTI stores x fastest: reshape to [T, Z, Y, X] then drop T
    arr = arr.reshape(nt, nz, ny, nx)
    if nt == 1:
        arr = arr[0]

    dx, dy, dz = (abs(pixdim[1]) or 1.0), (abs(pixdim[2]) or 1.0), (abs(pixdim[3]) or 1.0)
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    if qform_code > 0:
        qto = _quatern_to_mat44(*quatern[:3], *quatern[3:], dx, dy, dz, qfac)
    else:
        qto = np.diag([dx, dy, dz, 1.0])
    sto = None
    if sform_code > 0:
        sto = np.eye(4)
        sto[0, :] = srow[0:4]
        sto[1, :] = srow[4:8]
        sto[2, :] = srow[8:12]

    return NiftiImage(
        data=arr,
        voxel_size=(float(dx), float(dy), float(dz)),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        qto_xyz=qto,
        sto_xyz=sto,
    )


def write(
    path: str,
    data: np.ndarray,
    voxel_size=(1.0, 1.0, 1.0),
    qto_xyz: Optional[np.ndarray] = None,
    sto_xyz: Optional[np.ndarray] = None,
) -> None:
    """Write a single-file .nii / .nii.gz.

    data is [Z, Y, X]. When qto_xyz is given, qform_code=1 and the
    quaternion fields are derived via mat44_to_quatern; otherwise
    qform_code=0 and pixdim carries the scaling (the reference reader then
    builds qto_xyz = diag(pixdim)).
    """
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError("expected [Z, Y, X] volume")
    code = _DTYPE_CODES.get(np.dtype(data.dtype.newbyteorder("=")))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    nz, ny, nx = data.shape
    dx, dy, dz = [float(v) for v in voxel_size]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    qfac = 1.0
    b = c = d = qx = qy = qz = 0.0
    qform_code = 0
    if qto_xyz is not None:
        qform_code = 1
        b, c, d, qx, qy, qz, dx, dy, dz, qfac = mat44_to_quatern(np.asarray(qto_xyz))
    struct.pack_into("<8f", hdr, 76, qfac, dx, dy, dz, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    sform_code = 1 if sto_xyz is not None else 0
    struct.pack_into("<2h", hdr, 252, qform_code, sform_code)
    struct.pack_into("<6f", hdr, 256, b, c, d, qx, qy, qz)
    if sto_xyz is not None:
        s = np.asarray(sto_xyz, dtype=np.float64)
        struct.pack_into("<12f", hdr, 280, *s[0, :], *s[1, :], *s[2, :])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.ascontiguousarray(data).tobytes()
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


def read_volume(path: str) -> NiftiImage:
    """Read + convert to a float32 [Z, Y, X] image (the fioReadNifti
    equivalent, featExtract.cpp:84-220, without the isotropic resample)."""
    img = read(path)
    data = np.asarray(img.data, dtype=np.float32)
    if data.ndim == 4:
        data = data[0]
    return dataclasses.replace(img, data=data)
