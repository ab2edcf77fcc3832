"""The control of a cell's comparison: the program one precision step below
the one the configuration states, judged as a run is judged, so that each
limit can be set between what sound runs read and what the control reads.

The configurations state float32 (solver_dtype) with TF32 off, as the port
sets it on import; the control switches TF32 on for the port's matrix
products (torch.backends.cuda.matmul and cudnn), the path a later change
might take for speed.  Without --control the same loop reads sound runs,
several seeds in one process.  With --every it judges every unit of the
window, not only the one the seed draws, so that a short window reads
each recording of the mix.

    python3 portbench/control.py --workload <name> --seconds <s> \\
        --seeds 11 12 13 [--control] [--every]

Prints one JSON line per judged unit: the seed, the unit and its work,
whether the control was on, and every compared number.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run as harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--every", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import nautilus_tpu_torch  # noqa: F401  (sets TF32 off on import)
    torch.backends.cuda.matmul.allow_tf32 = args.control
    torch.backends.cudnn.allow_tf32 = args.control
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, judge, _, limits = harness.measure(
            args.workload, seed, args.seconds, False, "cuda", t_start=t0)
        units = range(len(run.unit_walls)) if args.every else [None]
        for k in units:
            checks = judge(k)
            correct, _ = harness.verdict(run, checks, limits)
            print(json.dumps({
                "seed": seed, "unit": k,
                "work": None if k is None else run.unit_keys[k],
                "control": args.control, "correct": correct,
                "units": len(run.unit_walls), "value": run.value,
                "checks": {n: (v if math.isfinite(v) else str(v))
                           for n, v in checks.items()},
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
