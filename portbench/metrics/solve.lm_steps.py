"""solve.lm_steps: Levenberg-Marquardt steps per map, accepted and
rejected, over the sweep's windows and the re-solve (the program's
WindowStats.iterations)."""

import statistics


def read(run):
    steps = run.counts.get("lm_steps")
    return statistics.fmean(steps) if steps and run.metric == "map_s" else None
