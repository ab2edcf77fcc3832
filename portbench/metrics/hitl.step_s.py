"""hitl.step_s: seconds per curation step (solve/hitl.hitl_callback:
solved odometry, selection, the two sweeps), the mean of the port's
``hitl.step`` spans in the window's sessions.  Nothing to read from a
program without them."""

import statistics


def read(run):
    spans = run.spans.get("hitl.step")
    return statistics.fmean(spans) if spans else None
