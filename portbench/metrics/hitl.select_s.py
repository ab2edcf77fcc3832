"""hitl.select_s: seconds per curation step in the pose selection
(solve/hitl.select_poses: the point-to-segment tests of every cloud on the
device and the host reads of the selected points), the mean of the port's
``hitl.select`` spans.  Nothing to read from a program without them."""

import statistics


def read(run):
    spans = run.spans.get("hitl.select")
    return statistics.fmean(spans) if spans else None
