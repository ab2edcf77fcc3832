"""Human-in-the-loop colinearity constraints (port of
nautilus_tpu/solve/hitl.py).

- ``HitlSlamInputMsg``: the two line segments a curator draws.
- ``select_poses``: for every node, transform its cloud by the current
  solution and test each point against both segments, batched over all
  nodes and points on the device.  The reference's else-if quirks are kept:
  a point near both lines counts only for line A, and a pose that qualifies
  for both lines joins only line A's set.
- ``build_hitl_factors``: each selected pose contributes point-to-segment
  residuals against the *line A* segment moved by the constraint's free line
  pose, for the poses of both lines (the colinearity merge).
- ``solved_odom_factors``: the densified odometry (every pair within the
  window, from the current solution) used for the first HITL solve.
- ``hitl_callback``: swap in solved odometry, add the constraint, solve,
  restore the ingest-time odometry, solve again.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from nautilus_tpu_torch.core import geometry as geo
from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.solve.factors import (HitlFactors, empty_hitl,
                                              hitl_residual)


@dataclasses.dataclass
class HitlSlamInputMsg:
    """Two line segments drawn by the curator."""

    line_a_start: np.ndarray
    line_a_end: np.ndarray
    line_b_start: np.ndarray
    line_b_end: np.ndarray

    @classmethod
    def from_points(cls, a0, a1, b0, b1):
        return cls(*[np.asarray(p, np.float64) for p in (a0, a1, b0, b1)])


@dataclasses.dataclass
class HitlConstraint:
    """Host-side record of one constraint."""

    line_a: Tuple[np.ndarray, np.ndarray]
    line_b: Tuple[np.ndarray, np.ndarray]
    # [(node_idx, points [k, 2] in the node frame), ...]
    line_a_poses: List[Tuple[int, np.ndarray]]
    line_b_poses: List[Tuple[int, np.ndarray]]
    line_pose_index: int   # row into state.line_poses


def _point_tests(points, points_mask, x, msg: HitlSlamInputMsg, width):
    """On-segment tests of every cloud point: (on_a, on_b) [N, P] bool."""
    dt, dev = points.dtype, points.device
    seg = [torch.as_tensor(np.asarray(p), dtype=dt, device=dev)
           for p in (msg.line_a_start, msg.line_a_end, msg.line_b_start,
                     msg.line_b_end)]
    width = torch.tensor(width, dtype=dt, device=dev)
    world = geo.pose_transform_points(x[:, None, :], points)
    on_a = points_mask & (geo.distance_to_line_segment(world, seg[0], seg[1])
                          <= width)
    # else-if: points on A never count for B.
    on_b = points_mask & ~on_a \
        & (geo.distance_to_line_segment(world, seg[2], seg[3]) <= width)
    return on_a, on_b


def select_poses(state: SLAMState, msg: HitlSlamInputMsg,
                 config) -> HitlConstraint:
    """The poses whose clouds lie on the drawn lines, with their on-line
    points."""
    problem = state.problem
    x = torch.as_tensor(state.solution, dtype=problem.points.dtype,
                        device=problem.device)
    on_a, on_b = _point_tests(problem.points, problem.points_mask, x, msg,
                              float(config.hitl_line_width))
    count_a = torch.sum(on_a, dim=1).cpu().numpy()
    count_b = torch.sum(on_b, dim=1).cpu().numpy()
    threshold = config.get_int("hitl_pose_point_threshold")
    a_nodes = np.nonzero(count_a >= threshold)[0]
    # else-if: a pose qualifying for both lines joins only A.
    b_nodes = np.nonzero((count_b >= threshold) & (count_a < threshold))[0]
    poses = []
    for nodes, on in ((a_nodes, on_a), (b_nodes, on_b)):
        idx = torch.as_tensor(nodes, device=problem.device)
        masks = on[idx].cpu().numpy()
        pts = problem.points[idx].cpu().numpy()
        poses.append([(int(node), pts[k][masks[k]].astype(np.float64))
                      for k, node in enumerate(nodes)])
    return HitlConstraint(
        line_a=(np.asarray(msg.line_a_start, np.float64),
                np.asarray(msg.line_a_end, np.float64)),
        line_b=(np.asarray(msg.line_b_start, np.float64),
                np.asarray(msg.line_b_end, np.float64)),
        line_a_poses=poses[0], line_b_poses=poses[1],
        line_pose_index=len(state.line_poses))


def build_hitl_factors(state: SLAMState, dtype=torch.float32) -> HitlFactors:
    """All constraints as one HitlFactors batch on the problem's device:
    one row per selected pose, padded to the longest row's point count."""
    dev = state.problem.device
    rows = []
    for c in state.hitl_constraints:
        line_dof = state.num_nodes + c.line_pose_index
        # The line A segment serves both pose sets.
        for node, pts in c.line_a_poses + c.line_b_poses:
            rows.append((node, line_dof, pts, c.line_a))
    if not rows:
        return empty_hitl(dev, dtype)
    r = len(rows)
    kmax = max(max(len(p) for _, _, p, _ in rows), 1)
    points = np.zeros((r, kmax, 2), np.float64)
    mask = np.zeros((r, kmax), bool)
    for q, (_, _, pts, _) in enumerate(rows):
        points[q, :len(pts)] = pts
        mask[q, :len(pts)] = True
    as_t = lambda a, t: torch.as_tensor(np.asarray(a), dtype=t, device=dev)
    return HitlFactors(
        node=as_t([row[0] for row in rows], torch.int64),
        line=as_t([row[1] for row in rows], torch.int64),
        points=as_t(points, dtype), mask=as_t(mask, torch.bool),
        seg_start=as_t([row[3][0] for row in rows], dtype),
        seg_end=as_t([row[3][1] for row in rows], dtype))


def hitl_cost(state: SLAMState) -> float:
    """0.5 * sum of squared HITL residuals at the state's solution and line
    poses (0 without constraints)."""
    rows = build_hitl_factors(state)
    if rows.node.shape[0] == 0:
        return 0.0
    x = torch.as_tensor(np.concatenate([state.solution, state.line_poses]),
                        dtype=rows.points.dtype, device=rows.points.device)
    r = torch.vmap(hitl_residual)(x[rows.node], x[rows.line], rows.points,
                                  rows.mask, rows.seg_start, rows.seg_end)
    return 0.5 * float(torch.sum(r * r))


def solved_odom_factors(state: SLAMState, max_window: int):
    """Every pair within max_window gets a factor carrying the current
    solution's relative pose (raw world-frame deltas, unwrapped rotation
    difference)."""
    sol = state.solution
    n = len(sol)
    jj = np.repeat(np.arange(1, n), np.minimum(np.arange(1, n), max_window))
    offsets = np.concatenate(
        [np.arange(min(j, max_window), 0, -1) for j in range(1, n)]
        or [np.zeros(0, np.int64)])
    ii = jj - offsets
    return ii, jj, sol[jj, :2] - sol[ii, :2], sol[jj, 2] - sol[ii, 2]


def angle_diff(a, b):
    d = a - b
    return d - 2.0 * np.pi * np.round(d / (2.0 * np.pi))


def solved_odom_factors_between(state: SLAMState, a: int, b: int):
    """Consecutive factors a..b from the current solution, with the wrapped
    rotation difference."""
    if b <= a:
        raise ValueError(f"need a < b, got a={a}, b={b}")
    sol = state.solution
    ii = np.arange(a, b)
    jj = ii + 1
    return ii, jj, sol[jj, :2] - sol[ii, :2], angle_diff(sol[jj, 2],
                                                         sol[ii, 2])


def total_odom_change(trans: np.ndarray, rot: np.ndarray):
    """Summed translation and wrapped-summed rotation over a factor list."""
    total_trans = trans.sum(axis=0) if len(trans) else np.zeros(2)
    total_rot = 0.0
    for r in rot:
        total_rot = float(angle_diff(total_rot + r, 0.0))
    return total_trans, total_rot


def hitl_callback(solver, msg: HitlSlamInputMsg, verbose: bool = True):
    """One curation step on a Solver: swap in solved odometry, add the
    constraint and its line pose, solve, restore the ingest-time odometry
    and solve again.  Returns the two SolveStats."""
    state: SLAMState = solver.state
    state.odometry_factors = solved_odom_factors(
        state, solver.config.get_int("lidar_constraint_amount_max"))
    constraint = select_poses(state, msg, solver.config)
    if verbose:
        print(f"Found {len(constraint.line_a_poses)} poses for the first line.")
        print(f"Found {len(constraint.line_b_poses)} poses for the second line.")
    state.hitl_constraints.append(constraint)
    state.line_poses = np.concatenate(
        [state.line_poses, np.zeros((1, 3), np.float64)], axis=0)
    if verbose:
        print("Solving problem with HITL constraints...")
    stats1 = solver.solve_slam()
    state.odometry_factors = state.initial_odometry_factors
    if verbose:
        print("Solving problem with initial odometry constraints...")
    stats2 = solver.solve_slam()
    return stats1, stats2
