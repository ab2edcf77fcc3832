"""Run one cell of the benchmark of the PyTorch/CUDA port and print its
result as one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (BENCHMARK.json's ``workloads``) names a configuration
(portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json), whose kind drives the window and
judges it (portbench/kinds/<kind>.py); its limits are in
portbench/limits/<workload>.json and each per-layer metric's reader in
portbench/metrics/<metric>.py.  All are found by name.

A run sets up (imports, kernel build or load, input synthesis from the
seed, one warm-up unit), measures for --seconds, then (--trace 1) profiles
one more unit, reads the memory peak, and judges what the window produced
against the plain reference (portbench/reference).  With --trace 0 it
reports the cell's end-to-end metrics, with --trace 1 its per-layer
metrics.  It exits 2 without the CUDA cards the cell asks for, and 3 if
jax, jaxlib, flax or the JAX package were imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nautilus_tpu")


def cache_env():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_json(path: Path):
    return json.loads(path.read_text())


def cell_files(bench: dict, workload: str):
    """(cell, config, mix) of a workload, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"))


def _applies(metric: dict, workload: str, reported=None):
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def end_to_end(bench, workload):
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer(bench, workload):
    e2e = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"] if _applies(m, workload, e2e)]


def _module(folder: str, name: str):
    """portbench/<folder>/<name>.py, loaded by its file name."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"),
        BENCH / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The read(run) function of portbench/metrics/<name>.py."""
    return _module("metrics", name).read


def kind(name: str):
    """The drive(...) function of portbench/kinds/<name>.py."""
    return _module("kinds", name).drive


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(workload, seed, seconds, trace, device="cuda", bench=None,
            t_start=None):
    """Set up and run the cell's window.  Returns (run, judge, cell,
    limits); judge() compares with the reference."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, conf, mix = cell_files(bench, workload)
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    run, judge = kind(mix["kind"])(
        mix, conf, seed, seconds, trace, device,
        T_START if t_start is None else t_start)
    return run, judge, cell, limits


def verdict(run, checks: dict, limits: dict):
    """(correct, {name: {value, limit}}): every limit needs a finite value
    at or under it, and every unit of the window must have succeeded."""
    shown = {k: {"value": checks.get(k, float("nan")), "limit": lim}
             for k, lim in limits.items()}
    ok = (run.failed == 0 and run.attempted > 0 and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in shown.values()))
    return ok, shown


def _number(v):
    """A JSON number; a non-finite value as its name."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def result_line(bench, workload, run, checks_shown, correct, trace, chips):
    import torch
    from portbench import roofline
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak),
              "power_limit_w": roofline.power_limit_w()}
    metrics, out = {}, {}
    if not trace:
        for m in end_to_end(bench, workload):
            value = run.setup_s if m["name"] == "setup_s" else run.value
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        device["busy_s"] = run.profiled["busy_s"]
        device["window_s"] = run.profiled["window_s"]
        for m in per_layer(bench, workload):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": run.profiled["device_ops"],
                            "idle_gaps": run.profiled["idle_gaps"]}
    line = {"correct": bool(correct), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    line.update(out)
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in checks_shown.items()}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_files(bench, args.workload)[0]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.manual_seed(args.seed)
    run, judge, _, limits = measure(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", bench)
    torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    correct, shown = verdict(run, judge(), limits)
    print(f"set-up {run.setup_s:.3f} s, {len(run.unit_walls)} units in the "
          f"window ({', '.join(f'{w:.3f}' for w in run.unit_walls)} s), "
          f"judged in {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(bench, args.workload, run, shown, correct,
                       bool(args.trace), chips)
    for name, v in shown.items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
