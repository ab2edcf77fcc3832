"""hitl.selected_poses: poses per curation step that the selection puts in
the constraint, both lines together (the HitlConstraint's pose lists).

The line pairs are fixed data, so this count moves only when the program's
map moves under them.  Fewer poses means less of the drawn curation was
done, which is why higher counts as better here: a change that makes the
lines catch fewer poses must not read as a gain.
"""

import statistics


def read(run):
    poses = run.counts.get("hitl.selected_poses")
    return statistics.fmean(poses) if poses else None
