"""portbench: the benchmark of sift3d_torch, the port on CUDA cards.

One command runs one cell once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the cell (``workloads/<cell>.json``: its configuration, its mix
and the mix's parameters), sets up and warms up through the mix
(``mixes/<mix>.py``), measures for --seconds, checks what the timed path
produced against the plain reference, and prints one JSON object as its
last line: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with --trace 1 ``breakdown``, and last ``checks``, each number compared
beside its limit. With --trace 0 the metrics are the cell's end-to-end
metrics of ``BENCHMARK.json``; with --trace 1 its per-layer metrics, from
a profiler trace of the window. Each metric is read by
``metrics/<name>.py``, or ``metrics/<prefix>.py`` for a name
``<prefix>.<cell kind>``. Without enough CUDA cards, or with JAX or the
JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Callable, Optional, Sequence  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sift3d")
CACHE = ROOT / ".portbench_cache"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """metrics/<name>.py, else metrics/<prefix>.py for <prefix>.<suffix>."""
    for candidate in (name, name.split(".", 1)[0]):
        if (HERE / "metrics" / f"{candidate}.py").is_file():
            return load_module("metrics", candidate)
    raise FileNotFoundError(f"no reader metrics/{name}.py for metric {name}")


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # BENCHMARK.json metrics this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, config_override: Optional[dict] = None, params_override: Optional[dict] = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name} in BENCHMARK.json")
    spec = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = load_json(HERE / "configs" / f"{spec['config']}.json")
    config.update(config_override or {})
    spec = dict(spec, params=dict(spec["params"], **(params_override or {})))
    return Cell(name, entry, spec, config, [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


def measure(mix, state, seconds: float, spans, max_calls: Optional[int] = None) -> dict:
    """Call the mix's unit back to back until `seconds` have passed (or
    max_calls were made); each unit ends with its results on the host."""
    latencies = []
    units = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        units += mix.unit(state, spans)
        te = time.perf_counter()
        latencies.append(te - ts)
        if te >= deadline or (max_calls is not None and len(latencies) >= max_calls):
            break
    return dict(units=units, calls=len(latencies), latencies_s=latencies, window_s=te - t0)


def run(name: str, seed: int, seconds: float, trace: bool, devices: Sequence[str],
        say: Callable[[str], None] = print, config_override: Optional[dict] = None,
        params_override: Optional[dict] = None, control: bool = False) -> dict:
    """One run of a cell on `devices`; returns the result object. control:
    the control (the reference one precision step down) takes the
    program's outputs' place in the check (``control.py`` and the tests;
    never in a benchmark run)."""
    import torch

    import roofline
    import devtrace as trace_mod
    from spans import OFF, Spans

    cell = load_cell(name, config_override, params_override)
    mix = load_module("mixes", cell.spec["mix"])
    state = mix.setup(cell.config, cell.spec["params"], seed, list(devices), say)
    mix.warmup(state, OFF)
    cuda = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
    for d in cuda:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - START

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans = Spans(devices)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace_mod.WINDOW):
                win = measure(mix, state, seconds, spans, cell.spec["params"].get("trace_calls"))
    else:
        win = measure(mix, state, seconds, OFF)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    traced = trace_mod.reduce(prof.events()) if prof is not None else None
    del prof
    bad = loaded_forbidden()
    if bad:
        raise ForbiddenModules(bad)

    # what a metric reader reads: the window (units, calls, latencies_s,
    # window_s), the trace (None untraced), the cell, the mix's state, the
    # devices and the peak device memory
    ctx = types.SimpleNamespace(cell=cell, config=cell.config, params=cell.spec["params"], state=state,
                  devices=[d.index for d in cuda], peak_bytes=peak, trace=traced, roofline=roofline,
                  setup_s=setup_s, **win)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = setup_s if m["name"] == "setup_s" else metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers, compared, failed = mix.check(state, control, say)
    say(f"check: {time.perf_counter() - t_check:.3f} s after the window")
    checks = {k: {"value": v, "limit": lim} for k, v, lim in numbers}
    correct = all(v <= lim for _, v, lim in numbers) and compared > 0
    say(f"compared {compared} outputs of the window against the reference; {failed} over a limit")

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["units"]), "failed": int(failed),
              "metrics": metrics, "device": device}
    if traced is not None:
        idx = ctx.devices or [0]
        device["busy_s"] = traced.busy_s(idx)
        device["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown(idx)
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths (the port
    # builds its kernels into sift3d_torch/_build/<source hash>/ itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(1, str(ROOT))

    import torch

    chips = load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {found}; no result", file=sys.stderr)
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     [f"cuda:{i}" for i in range(chips)])
    except ForbiddenModules as e:
        print(f"portbench: modules loaded in the run's process: {', '.join(e.args[0])}; no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: modules loaded in the run's process: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
