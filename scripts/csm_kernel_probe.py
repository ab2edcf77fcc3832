#!/usr/bin/env python3
"""Time the port's two CSM kernels on one CUDA card beside their bounds, their
plain versions and, for the correlation, its one-call PyTorch yardstick.

    python3 scripts/csm_kernel_probe.py [--tree DIR ...] [--reps N]

Each ``--tree`` is the root of a checkout whose ``nautilus_tpu_torch`` is
measured (default: this checkout); each tree runs in its own process, in
the order given, so ``--tree A --tree B --tree B --tree A`` alternates two
versions on one card.  Per tree and shape it prints ``chip_smoke.py``'s
check of the kernel against its plain version, then one JSON line:

- correlate at the pair engine's batch (B=16) at 30 m, 12 m and 8.5 m;
- fused_coarse at the main path's chunk (C=64) and at C=8, 30 m and 8.5 m;

with the kernel's CUDA-event time, its device time under ``torch.profiler``,
the plain version's time, the bound and, for ``correlate``, the grouped
``F.conv2d`` yardstick.  The cases are ``chip_smoke.py``'s phase 3 and 4
cases (inputs, timer, bound, yardstick), loaded from this checkout whatever
tree is measured.  Fails without a card or when a kernel disagrees with its
plain version.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def profiled_ms(fn, name_part, reps=5):
    """Mean device time per launch of the kernels whose name holds
    ``name_part``, under torch.profiler (None if it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name_part in ev.key:
            total += getattr(ev, "device_time_total", None) or ev.cuda_time_total
            count += ev.count
    return total / count / 1e3 if count else None


def probe(case, kernel_name):
    """chip_smoke's record of one case (the kernel held to its plain version,
    timed, beside its bound), with the kernel's device time."""
    rec = case()
    rec["profiler_ms"] = profiled_ms(rec.pop("run"), kernel_name)
    return rec


def run_tree(tree, reps):
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("csm_kernel_probe: FAIL: no CUDA card", flush=True)
        return 1
    import nautilus_tpu_torch  # noqa: F401  (turns TF32 off)
    from nautilus_tpu_torch.kernels import _build, csm_coarse, csm_correlate
    smoke = _load("chip_smoke_helpers", ROOT / "chip_smoke.py")
    _build.build_all([csm_coarse.SOURCE, csm_correlate.SOURCE])
    dev = torch.device("cuda")
    card = smoke.card_line()
    cases = [(lambda: smoke.correlate_case(dev, 30.0, 16, 4, reps),
              "correlate"),
             (lambda: smoke.correlate_case(dev, 12.0, 16, 5, reps),
              "correlate"),
             (lambda: smoke.correlate_case(dev, 8.5, 16, 6, reps),
              "correlate"),
             (lambda: smoke.kernel_case(dev, 30.0, 64, seed=2, reps=reps),
              "coarse"),
             (lambda: smoke.kernel_case(dev, 30.0, 8, seed=0, reps=reps),
              "coarse"),
             (lambda: smoke.kernel_case(dev, 8.5, 8, seed=1, reps=reps),
              "coarse")]
    for case, kernel_name in cases:
        rec = probe(case, kernel_name)
        rec.update(tree=str(tree), card=card)
        print(json.dumps(rec), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return run_tree(Path(args.child).resolve(), args.reps)
    rc = 0
    for tree in args.tree or [str(ROOT)]:
        rc |= subprocess.run([sys.executable, __file__, "--child", tree,
                              "--reps", str(args.reps)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
