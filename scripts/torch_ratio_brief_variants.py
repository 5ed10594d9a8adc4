"""What limits M2's int8 route (csrc/ratio_match.cu) and the fused BRIEF
kernel (csrc/rotated_brief.cu) on a CUDA card.

Builds versions of each kernel source into their own libraries and times
each back to back (a call's share of a burst of 20; the kernel alone):

M2, 30,039 queries (31 copies of 969 rows of GoH ranks, three ranks of
each swapped, seeded) against the 969 rows, their positions spread over a
T1 volume or crowded into a 10-voxel cube (many compatible events):
  as is               the port's kernel;
  tests in row order  each lane tests its marked events in row order,
                      every one that may still lower the smallest counted
                      event, instead of smallest first;
  no test             every marked event counts without its test (the
                      floor of the tests' cost; not the port's result);
  eight warps         blocks of 8 warps (128 queries) instead of 4.
The fused BRIEF kernel, RRIEF, 4096 rotated rows (scales 1.5..6) in a
seeded normal [6, 182, 218, 182] stack, beside K4's patch mode alone:
  as is, no normalization, no pre-blur, no rank (each a step taken out;
  only "as is" gives the port's result).

Prints one JSON line with the card's name and power limit.

    python scripts/torch_ratio_brief_variants.py

Needs a CUDA card and nvcc; builds into sift3d_torch/_build/ratio_brief_variants/.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALLEST_FIRST = """          int k = 0, val = kNone;
#pragma unroll
          for (int c = 0; c < kSeg; ++c)
            if (((marked >> c) & 1u) && d[r][c] < val) {
              val = d[r][c];
              k = c;
            }
          marked &= ~(1u << k);
          if (val >= best[r]) break;"""
ROW_ORDER = """          const int k = __ffs(marked) - 1;
          int val = kNone;
#pragma unroll
          for (int c = 0; c < kSeg; ++c)
            if (c == k) val = d[r][c];
          marked &= marked - 1;
          if (val >= best[r]) continue;"""
RATIO = {
    "as is": [],
    "tests in row order": [(SMALLEST_FIRST, ROW_ORDER), ("            best[r] = val;\n            break;",
                                                         "            best[r] = val;")],
    "no test": [("if (!compatible) {", "if (compatible || true) {")],
    "eight warps": [("constexpr int kI8Warps = 4;", "constexpr int kI8Warps = 8;"),
                    ("__launch_bounds__(kI8Threads, 4)", "__launch_bounds__(kI8Threads, 2)")],
}
BRIEF = {
    "as is": [],
    "no normalization": [("  normalize_patch(p, red);\n", "")],
    "no pre-blur": [("b[i] = blur_chain<R>(taps, x, kD, [&](int k) { return p[zy * kD + k]; });", "b[i] = p[i];"),
                    ("p[i] = blur_chain<R>(taps, y, kD, [&](int k) { return b[(z * kD + k) * kD + x]; });",
                     "p[i] = b[i];"),
                    ("ends[threadIdx.x] = blur_chain<R>(taps, z, kD, [&](int k) { return p[k * kD * kD + yx]; });",
                     "ends[threadIdx.x] = p[i];")],
    "no rank": [("k += w < v || (j < i && w == v);", "k = i;")],
}


def build(source: str, variants: dict, out_dir: str, tag: str) -> dict:
    """{variant: (library path, nvcc process)}, all compiling at once."""
    from sift3d_torch.kernels import cuda_lib

    text0 = (cuda_lib.CSRC_DIR / source).read_text()
    procs = {}
    for name, subs in variants.items():
        text = text0
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{tag} {name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        stem = f"{tag}_{name.replace(' ', '_')}"
        src = os.path.join(out_dir, f"{stem}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{stem}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def load(procs: dict, entry: str, kernel: str):
    """{variant: the C entry}, and {variant: ptxas registers and spills of kernel}."""
    from sift3d_torch.kernels import cuda_lib

    fns, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = list(cuda_lib.SIGNATURES[entry]) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if kernel in line and "Compiling entry" in line:
                regs[name] = " ".join(x.strip() for x in lines[i + 2 : i + 4])
    return fns, regs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ratio_brief_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import burst_ms, card_line
    from sift3d_torch.kernels import cuda_lib, descriptor, gauss_cuda, patch_cuda
    from sift3d_torch.match import pairwise

    out_dir = os.path.join(HERE, "sift3d_torch", "_build", "ratio_brief_variants")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(cuda_lib.CSRC_DIR / "common.cuh", out_dir)
    ratio_procs = build("ratio_match.cu", RATIO, out_dir, "ratio")
    brief_procs = build("rotated_brief.cu", BRIEF, out_dir, "brief")
    ratio_fns, ratio_regs = load(ratio_procs, "sift3d_ratio_match_i8", "ratio_i8_kernelILb1")
    brief_fns, brief_regs = load(brief_procs, "sift3d_rotated_brief", "brief_kernelILi2ELb1")

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(5)
    db = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (969, 1)), axis=1)
    q = np.tile(db, (31, 1))
    rows = np.arange(q.shape[0])
    for _ in range(3):
        a, b = rng.integers(0, 64, (2, q.shape[0]))
        q[rows, a], q[rows, b] = q[rows, b], q[rows, a].copy()
    scale = rng.uniform(1.5, 8, 969).astype(np.float32)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    qt, dbt, st = put(q), put(db), put(scale)
    thr = float(np.float32(np.log(1.5)))
    nq, nd, npad = q.shape[0], db.shape[0], 1024
    db8 = torch.empty((npad, 16), dtype=torch.int32, device=dev)
    dn = torch.empty(npad, dtype=torch.float32, device=dev)
    cuda_lib.launch("sift3d_knn_prep_i8", dbt, db8, dn, None, nd, npad, 64, device=dev)
    times, equal = {}, {}
    for geo, lo, hi in (("spread", 20.0, 160.0), ("crowded", 20.0, 30.0)):
        xyz = put(rng.uniform(lo, hi, (nd, 3)))
        want = pairwise.ratio_rows_plain(qt, dbt, xyz, st, thr, 0.5)
        idx = torch.empty(nq, dtype=torch.int64, device=dev)
        ratio = torch.empty(nq, dtype=torch.float32, device=dev)
        for name, fn in ratio_fns.items():
            def call(fn=fn):
                err = fn(qt.data_ptr(), db8.data_ptr(), dn.data_ptr(), xyz.data_ptr(), st.data_ptr(),
                         idx.data_ptr(), ratio.data_ptr(), nq, nd, thr, 0.5, dev.index, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            equal[f"M2 {name}, {geo}"] = bool(torch.equal(idx, want[0]) and torch.equal(ratio, want[1]))
            times[f"M2 {name}, {geo}"] = burst_ms(call)

    n = 4096
    gs = torch.from_numpy(rng.standard_normal((6, 182, 218, 182)).astype(np.float32)).to(dev)
    lvl = torch.from_numpy(rng.integers(1, 4, n).astype(np.int32)).to(dev)
    cen = put(rng.uniform(20, 160, (n, 3)))
    scl = put(rng.uniform(1.5, 6, n))
    oris = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, 3, 3)).astype(np.float32)))[0].contiguous().to(dev)
    flat, dist = descriptor.brief_pairs(2, dev)
    taps = gauss_cuda.host_taps(0.95, 0.01)
    want = patch_cuda.rotated_brief_plain(gs, lvl, cen, scl, oris, 0, None, "rrief")
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    for name, fn in brief_fns.items():
        def call(fn=fn):
            err = fn(gs.data_ptr(), lvl.data_ptr(), cen.data_ptr(), scl.data_ptr(), oris.data_ptr(), flat.data_ptr(),
                     dist.data_ptr(), taps.data_ptr(), taps.shape[0] // 2, 1, out.data_ptr(), n, 6, 182, 218, 182,
                     0, 182, dev.index, stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError {err}")
        call()
        torch.cuda.synchronize()
        equal[f"BRIEF {name}"] = bool(torch.equal(out, want))
        times[f"BRIEF {name}"] = burst_ms(call)
    times["K4's patch mode alone"] = burst_ms(lambda: patch_cuda.sample_rotated(gs, lvl, cen, scl, oris))
    print(json.dumps({"card": card_line(), "b2b_ms": times, "equal_to_plain": equal,
                      "ptxas ratio_i8_kernel<1>": ratio_regs, "ptxas brief_kernel<2, 1>": brief_regs}))
    bad = [key for key, ok in equal.items() if not ok and key in ("BRIEF as is",) + tuple(
        f"M2 {v}, {g}" for v in ("as is", "tests in row order", "eight warps") for g in ("spread", "crowded"))]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
