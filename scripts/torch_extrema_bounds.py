"""What limits K1 and K6 (sift3d_torch/csrc/dogs_extrema.cu) on a CUDA card.

Builds four versions of the kernel source into their own libraries and
times each, back to back, at the chosen launch on the T1 octave-0 shapes
(a [6, 182, 218, 182] Gaussian stack for K1, its [5, ...] DoGs for K6):

  as is          the kernel of the port;
  memory only    the neighbourhood test removed (the mask is the centre's
                 sign): the loads, stores, shuffles and barriers remain;
  no loads       the inputs made from the coordinates instead of loaded:
                 the arithmetic and the stores remain;
  3 blocks an SM K6's registers capped so that three blocks of 8 rows fit
                 on an SM (two as it is).

A kernel that takes as long as its "memory only" version is bound by its
memory traffic; one that takes as long as its "no loads" version by its
instructions. Prints one JSON line with the card's name and power limit.

    python scripts/torch_extrema_bounds.py

Needs a CUDA card and nvcc; builds into sift3d_torch/_build/bounds/.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "as is": [],
    "memory only": [("m[c - 1] = v > n.x ? 1 : (v < n.y ? -1 : 0);",
                     "m[c - 1] = v > 0.0f ? 1 : (v < 0.0f ? -1 : 0);")],
    "no loads": [("nxt[l] = in_xy ? src[l * vol + off] : 0.0f;",
                  "nxt[l] = (float)((int)((xy + off) * 7 + l * 5) & 63);")],
    "3 blocks an SM": [("__launch_bounds__(LANES * (TY + 2))\nextrema_mask_kernel",
                        "__launch_bounds__(LANES * (TY + 2), TY == 8 ? 3 : 1)\nextrema_mask_kernel")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_extrema_bounds: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import burst_ms, card_line
    from sift3d_torch.kernels import cuda_lib, extrema_cuda

    out_dir = os.path.join(HERE, "sift3d_torch", "_build", "bounds")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(cuda_lib.CSRC_DIR / "common.cuh", out_dir)
    source = (cuda_lib.CSRC_DIR / "dogs_extrema.cu").read_text()
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
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (lib, proc)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        handle = ctypes.CDLL(lib)
        for fn_name in ("sift3d_dogs_extrema", "sift3d_extrema_mask"):
            fn = getattr(handle, fn_name)
            fn.argtypes = list(cuda_lib.SIGNATURES[fn_name]) + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = handle

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (182, 218, 182)
    gs = torch.randn((6, *shape), device=dev, generator=gen)
    gs = torch.nn.functional.avg_pool3d(gs[None], 3, 1, 1)[0].contiguous()
    dogs = (gs[:-1] - gs[1:]).contiguous()
    g1 = extrema_cuda.extrema_launch_geometry((1, *shape), "dogs_extrema")
    g6 = extrema_cuda.extrema_launch_geometry((1, *shape), "extrema_mask")
    out_d = torch.empty_like(dogs)
    out_m = torch.empty((3, *shape), dtype=torch.int8, device=dev)

    def k1(lib):
        err = lib.sift3d_dogs_extrema(gs.data_ptr(), out_d.data_ptr(), out_m.data_ptr(), 1, *shape,
                                      g1["ty"], g1["zr"], 0, stream)
        assert err == 0, err

    def k6(lib):
        err = lib.sift3d_extrema_mask(dogs.data_ptr(), out_m.data_ptr(), 1, *shape, g6["ty"], g6["zr"],
                                      0, stream)
        assert err == 0, err

    times = {}
    for _ in range(2):  # two rounds, in turns
        for name, lib in libs.items():
            for kernel, fn in (("K1", k1), ("K6", k6)):
                times.setdefault(f"{kernel} {name}", []).append(burst_ms(lambda: fn(lib)))
    print(json.dumps({"card": card_line(), "shape": shape, "launch": {"K1": g1, "K6": g6},
                      "back_to_back_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
