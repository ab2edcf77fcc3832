"""solve.sweep_s: seconds per map in the first growing-window solve
(solve/solver, correspond, band, lm), from the benchmark's synchronised
span around solve_slam."""

import statistics


def read(run):
    spans = run.spans.get("solve")
    return statistics.fmean(spans) if spans else None
