"""hitl.lm_steps: Levenberg-Marquardt steps per curation step, accepted and
rejected, over the windows of its two sweeps (the program's
WindowStats.iterations)."""

import statistics


def read(run):
    steps = run.counts.get("hitl.lm_steps")
    return statistics.fmean(steps) if steps else None
