"""A curation session as the benchmark drives the port.  Like program.py it
imports the PyTorch/CUDA port (nautilus_tpu_torch) only inside its
functions, and it times nothing itself.

A session runs the port's normal path, the calls the CLI's --hitl_replay
makes: preprocessing and the problem build (program.make_state), the
growing-window sweep (Solver.solve_slam), then each line pair through
hitl_callback.  For the comparison the session keeps, on the host, the
poses and line poses after every window of every solve (through the
solver's visualizer hook, which writes them back after each window: a
copy of a few kilobytes that the window's own finiteness check has
already waited for), each solve's per-window LM steps and each step's
selection.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from portbench import program


@dataclasses.dataclass
class Solve:
    """The state after one solve_slam."""

    x: np.ndarray                  # [N, 3] poses
    lines: np.ndarray              # [L, 3] line poses
    iterations: List[int]          # LM steps per window
    windows: List[tuple]           # (poses, line poses) after each window


@dataclasses.dataclass
class Step:
    """One curation step: what it entered with, what it selected, and its
    two solves (solved odometry, then the recorded odometry)."""

    x_in: np.ndarray
    lines_in: np.ndarray
    seg_a: np.ndarray              # [2, 2] line A, the constraint's segment
    seg_b: np.ndarray              # [2, 2] line B
    nodes_a: List[int]
    nodes_b: List[int]
    points: List[np.ndarray]       # on-line points, A's poses then B's
    solves: List[Solve]


@dataclasses.dataclass
class SessionOut:
    sweep: Solve
    steps: List[Step]


def tracing(on: bool):
    """Switch the port's in-memory tracer on or off."""
    from nautilus_tpu_torch.utils import timer
    timer.tracing(on)


def take():
    """The port's spans recorded since the last take(): [(name, seconds)]."""
    from nautilus_tpu_torch.utils import timer
    return [(s.name, (s.t1_ns - s.t0_ns) * 1e-9) for s in timer.take()]


class _Windows:
    """A visualizer (the port's SolverVisualizer interface) that keeps the
    poses and line poses after each window of a solve."""

    def __init__(self):
        self.ends = []

    def draw_solution(self, state, window=None):
        if window is not None:
            self.ends.append((state.solution.copy(), state.line_poses.copy()))

    def draw_correspondence(self, correspondences):
        pass


def _recording(solver, windows: _Windows, into: List[Solve]):
    """Keep a Solve of every solve_slam this solver runs."""
    plain = solver.solve_slam

    def solve_slam(*args, **kwargs):
        windows.ends = []
        stats = plain(*args, **kwargs)
        into.append(Solve(solver.state.solution.copy(),
                          solver.state.line_poses.copy(),
                          [w.iterations for w in stats.windows],
                          windows.ends))
        return stats
    solver.solve_slam = solve_slam


def swept(scans, cfg, device, span: program.Span = program._null_span):
    """(solver, its Solves): preprocess, then the sweep, whose Solve is the
    list's first.  The solver is program.solver's, with the window
    recorder as its visualizer."""
    from nautilus_tpu_torch.solve.solver import Solver
    state = program.make_state(scans, cfg, device, span)
    windows = _Windows()
    sv = Solver(state, cfg, visualizer=windows,
                linear_solver=cfg.get("linear_solver", "auto"),
                assembly=cfg.get("assembly", None) or None)
    solves: List[Solve] = []
    _recording(sv, windows, solves)
    with span("solve"):
        sv.solve_slam()
    return sv, solves


def curate(sv, solves: List[Solve], pairs: Sequence[Sequence[float]],
           span: program.Span = program._null_span) -> List[Step]:
    """Each pair [ax, ay, ax2, ay2, bx, by, bx2, by2] as one curation step
    on the solver that swept() returned."""
    from nautilus_tpu_torch.solve.hitl import HitlSlamInputMsg, hitl_callback
    state = sv.state
    steps = []
    with span("hitl"):
        for p in pairs:
            x_in, lines_in = state.solution.copy(), state.line_poses.copy()
            msg = HitlSlamInputMsg.from_points(p[0:2], p[2:4], p[4:6],
                                               p[6:8])
            hitl_callback(sv, msg, verbose=False)
            c = state.hitl_constraints[-1]
            both = c.line_a_poses + c.line_b_poses
            steps.append(Step(
                x_in, lines_in, np.stack(c.line_a), np.stack(c.line_b),
                [v for v, _ in c.line_a_poses],
                [v for v, _ in c.line_b_poses], [pts for _, pts in both],
                solves[-2:]))
    return steps


def session(scans, cfg, device, pairs: Sequence[Sequence[float]],
            span: program.Span = program._null_span) -> SessionOut:
    """One curated map: preprocess, the sweep, then each pair as one
    curation step."""
    sv, solves = swept(scans, cfg, device, span)
    return SessionOut(solves[0], curate(sv, solves, pairs, span))
