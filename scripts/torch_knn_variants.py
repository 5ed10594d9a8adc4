"""What limits M1's int8 route (sift3d_torch/csrc/knn_topk.cu) on a CUDA card.

Builds versions of the kernel source into their own libraries and times
each, back to back (a call's share of a burst of 20: the pre-pass, the main
kernel and, with slices, the merge), with k = 5, on 969 rows of GoH ranks
(random permutations of 0..63, seeded) tiled to 48,000 rows as
chip_smoke.py's phase 2 tiles the extraction's: all to all, and a quarter
shard of 12,000 queries (the database cut into slices, then merged):

  as is           the kernel of the port (at KM <= 8 its registers capped
                  so that at least two blocks of 256 threads fit on an SM),
                  and on the quarter shard at the slice counts int8_plan
                  gives for 1 to 6 resident blocks an SM (1, 2, 4, 5, 7, 8),
                  beside the slices it cuts for the card's own count;
  uncapped        the main kernel's registers left to the compiler;
  rolled          the loop over a tile's 8-row subtiles kept rolled;
  no selection    the reject test and the insert removed: the loads, the
                  tensor-core product and the distances remain.

Every version but "no selection" must give the port's result, equal to
the plain version. Prints one JSON line with the card's name and power
limit.

    python scripts/torch_knn_variants.py

Needs a CUDA card and nvcc; builds into sift3d_torch/_build/knn_variants/.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAIN = "__launch_bounds__(kI8Threads, KM <= 8 ? 2 : 1)\nknn_topk_i8_kernel"
VARIANTS = {
    "as is": [],
    "uncapped": [(MAIN, "__launch_bounds__(kI8Threads)\nknn_topk_i8_kernel")],
    "rolled": [("    for (int n0 = 0; n0 < nr; n0 += 8) {",
                "#pragma unroll 1\n    for (int n0 = 0; n0 < nr; n0 += 8) {")],
    "no selection": [("if (d <= bd[r][KM - 1] && before(d, j, bd[r][KM - 1], bi[r][KM - 1]))",
                      "if (d == -1.0f)")],
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_knn_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import MATCH_ROWS, burst_ms, card_line
    from sift3d_torch.kernels import cuda_lib, knn_cuda

    out_dir = os.path.join(HERE, "sift3d_torch", "_build", "knn_variants")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(cuda_lib.CSRC_DIR / "common.cuh", out_dir)
    source = (cuda_lib.CSRC_DIR / "knn_topk.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        src = os.path.join(out_dir, f"{stem}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{stem}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        handle = ctypes.CDLL(lib)
        for entry, args in cuda_lib.SIGNATURES.items():
            if entry.startswith("sift3d_knn"):
                fn = getattr(handle, entry)
                fn.argtypes = list(args) + [ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = handle
        # ptxas: the registers and spills of knn_topk_i8_kernel<64, 5> (k = 5)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "knn_topk_i8_kernelILi64ELi5E" in line and "Compiling entry" in line:
                regs[name] = " ".join(x.strip() for x in lines[i + 2 : i + 4])

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    ranks = rng.permuted(np.tile(np.arange(64, dtype=np.float32), (969, 1)), axis=1)
    x = torch.as_tensor(np.tile(ranks, (-(-MATCH_ROWS // 969), 1))[:MATCH_ROWS], device=dev)
    k = 5
    cases = {"all to all 48,000": x, "quarter shard 12,000 x 48,000": x[: MATCH_ROWS // 4]}
    want = {label: knn_cuda.knn_topk_plain(q, x, k) for label, q in cases.items()}
    library, places = cuda_lib.library, knn_cuda.int8_places
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    times, equal = {}, {}
    try:
        for name, handle in libs.items():
            cuda_lib.library = lambda handle=handle: handle
            places.cache_clear()  # each version's own occupancy
            for label, q in cases.items():
                got = knn_cuda.knn_topk_int8(q, x, k)
                torch.cuda.synchronize()
                equal[f"{name}, {label}"] = bool(torch.equal(got[0], want[label][0])
                                                  and torch.equal(got[1], want[label][1]))
                times[f"{name}, {label}"] = burst_ms(lambda q=q: knn_cuda.knn_topk_int8(q, x, k))
        # the quarter shard at other slice counts: int8_plan's with another
        # count of resident blocks an SM
        cuda_lib.library = lambda: libs["as is"]
        places.cache_clear()
        q = cases["quarter shard 12,000 x 48,000"]
        plan_slices = knn_cuda.int8_plan(q.shape[0], MATCH_ROWS, places(dev, x.shape[1], k))[0]
        slices = {}
        for resident in (1, 2, 3, 4, 5, 6):
            knn_cuda.int8_places = lambda device, c, k, resident=resident: resident * sms
            slices[knn_cuda.int8_plan(q.shape[0], MATCH_ROWS, resident * sms)[0]] = burst_ms(
                lambda: knn_cuda.knn_topk_int8(q, x, k))
    finally:
        cuda_lib.library = library
        knn_cuda.int8_places = places
        places.cache_clear()
    print(json.dumps({"card": card_line(), "rows": MATCH_ROWS, "k": k, "b2b_ms": times,
                      "as is, quarter shard, b2b_ms by slices": slices,
                      "int8_plan's slices": plan_slices,
                      "equal_to_plain": equal, "ptxas knn_topk_i8_kernel<64, 5>": regs}))
    bad = [key for key, ok in equal.items() if not ok and not key.startswith("no selection")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
