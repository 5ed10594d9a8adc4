"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2

For each of --seeds, one short run of the cell (``run.run``, untraced,
--seconds long) with the program, as the benchmark runs it: the lower
readings. For each of --control-seeds, the same run with the control in
the program's place: the reference computed one precision step below the
configuration's (the blur's matmuls in TF32; the group match's f32 steps
in bf16 and its f64 steps in f32): the upper readings. All in one
process, so the set-up of torch is paid once.
Prints one JSON line: {"program": {seed: {check: value}}, "control": ...}.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(1, str(run.ROOT))
    import torch

    chips = run.load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("control: not enough CUDA cards", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    out = {"workload": args.workload, "program": {}, "control": {}}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            res = run.run(args.workload, seed, args.seconds, False, devices, control=kind == "control")
            out[kind][seed] = {k: c["value"] for k, c in res["checks"].items()}
            print(f"{kind} seed {seed}: correct {res['correct']}, {out[kind][seed]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
