"""Full-state checkpointing (npz), beyond the reference's pose files (port of
nautilus_tpu/io/checkpoint.py).

The reference persists only the pose text file (solver.cc:565-579), so HITL
constraints are lost across sessions.  This module saves and restores the
whole curation session: solution poses, timestamps, HITL constraints (line
segments, per-pose point sets, line poses) and accepted auto-LC factors.
The npz keys are the JAX package's, so a session saved by either package
loads in the other.  The pose file (io/poses.py) stays the interchange
format with the reference.
"""

from __future__ import annotations

import numpy as np

from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.solve.hitl import HitlConstraint


def save_state(state: SLAMState, path) -> None:
    data = {
        "solution": state.solution,
        "timestamps": state.timestamps,
        "line_poses": state.line_poses,
        "num_hitl": np.array(len(state.hitl_constraints)),
        "num_lc": np.array(len(state.lc_factors)),
    }
    for c_idx, c in enumerate(state.hitl_constraints):
        p = f"hitl{c_idx}_"
        data[p + "line_a"] = np.stack(c.line_a)
        data[p + "line_b"] = np.stack(c.line_b)
        data[p + "line_pose_index"] = np.array(c.line_pose_index)
        for side, poses in (("a", c.line_a_poses), ("b", c.line_b_poses)):
            data[p + f"{side}_nodes"] = np.array(
                [n for n, _ in poses], np.int64)
            for k, (_, pts) in enumerate(poses):
                data[p + f"{side}_pts{k}"] = np.asarray(pts)
    for k, (i, j, trans, rot, wt, wr) in enumerate(state.lc_factors):
        data[f"lc{k}"] = np.array([i, j, trans[0], trans[1], rot, wt, wr])
    np.savez_compressed(path, **data)


def load_state(state: SLAMState, path) -> SLAMState:
    """Restore a saved session into an existing state (same problem)."""
    z = np.load(path)
    state.solution = z["solution"].copy()
    state.timestamps = z["timestamps"].copy()
    state.line_poses = z["line_poses"].copy()
    state.hitl_constraints = []
    for c_idx in range(int(z["num_hitl"])):
        p = f"hitl{c_idx}_"
        la = z[p + "line_a"]
        lb = z[p + "line_b"]

        def side_poses(side):
            nodes = z[p + f"{side}_nodes"]
            return [(int(n), z[p + f"{side}_pts{k}"])
                    for k, n in enumerate(nodes)]

        state.hitl_constraints.append(HitlConstraint(
            line_a=(la[0], la[1]), line_b=(lb[0], lb[1]),
            line_a_poses=side_poses("a"), line_b_poses=side_poses("b"),
            line_pose_index=int(z[p + "line_pose_index"])))
    state.lc_factors = []
    for k in range(int(z["num_lc"])):
        v = z[f"lc{k}"]
        state.lc_factors.append(
            (int(v[0]), int(v[1]), np.array([v[2], v[3]]), float(v[4]),
             float(v[5]), float(v[6])))
    return state
