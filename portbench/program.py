"""The system under test, as the benchmark drives it: the only module of
the benchmark that imports the PyTorch/CUDA port (nautilus_tpu_torch), and
only inside its functions.

It hands the port the benchmark's scans and reads back what the port
returns: poses, the loop-closure report and the SolveStats counts.  It times nothing itself; callers pass a
``span`` context manager that does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List

import numpy as np

Span = Callable[[str], contextlib.AbstractContextManager]


def _null_span(name):
    return contextlib.nullcontext()


def config(keys: dict, source: str):
    """The port's Config from a configuration file's resolved keys."""
    from nautilus_tpu_torch.core.luaconf import Config
    return Config(dict(keys), source)


def build_kernels():
    """Build the port's CUDA kernels, or find them built in the checkout."""
    from nautilus_tpu_torch.kernels import _build
    _build.build_all(sorted(_build.CSRC.glob("*.cu")))


def make_state(scans, cfg, device, span: Span = _null_span):
    """The port's preprocessing (normals, features) and problem build on
    ``device`` from the benchmark's scans; returns a SLAMState."""
    from nautilus_tpu_torch.core.preprocess import preprocess
    from nautilus_tpu_torch.core.problem import (RawNodes, SLAMState,
                                                 build_problem,
                                                 resolve_solver_dtype)
    with span("preprocess"):
        raw = RawNodes(points=scans.points, points_mask=scans.points_mask,
                       initial_poses=scans.initial_poses,
                       timestamps=scans.timestamps, odom_i=scans.odom_i,
                       odom_j=scans.odom_j, odom_trans=scans.odom_trans,
                       odom_rot=scans.odom_rot)
        dtype = resolve_solver_dtype(cfg.get("solver_dtype", "float32"))
        normals, pi, pm, ei, em, _ = preprocess(
            raw.points, raw.points_mask, device, config=cfg)
        problem = build_problem(raw, normals, pi, pm, ei, em, device, dtype)
        state = SLAMState.from_problem(problem, raw.timestamps)
    return state


def solver(state, cfg):
    from nautilus_tpu_torch.solve.solver import Solver
    return Solver(state, cfg, linear_solver=cfg.get("linear_solver", "auto"),
                  assembly=cfg.get("assembly", None) or None)


@dataclasses.dataclass
class MapOut:
    """What one closed map returned."""

    x_sweep: np.ndarray            # poses after solve_slam
    x_closed: np.ndarray           # poses after auto-LC's re-solve
    lm_steps: int                  # LM steps of the sweep and re-solve
    candidates: List[int]
    gated_pairs: List[tuple]
    csm: List[tuple]               # (s, t, score, [tx, ty, theta])


def closed_map(scans, cfg, device, auto_lc: bool, span: Span = _null_span):
    """One map: preprocess, the growing-window sweep, then (auto_lc) the
    loop closures and the re-solve; poses on the host at the end."""
    state = make_state(scans, cfg, device, span)
    sv = solver(state, cfg)
    with span("solve"):
        stats = sv.solve_slam()
    x_sweep = state.solution.copy()
    steps = sum(w.iterations for w in stats.windows)
    out = MapOut(x_sweep, x_sweep, steps, [], [], [])
    if auto_lc:
        from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
        with span("lc"):
            rep = solve_auto_lc(sv, apply=True, verbose=False)
        out.x_closed = state.solution.copy()
        if rep.resolve_stats is not None:
            out.lm_steps += sum(w.iterations for w in rep.resolve_stats.windows)
        out.candidates = list(rep.candidates)
        out.gated_pairs = list(rep.gated_pairs)
        out.csm = [(int(s), int(t), float(sc), np.asarray(tf, np.float64))
                   for s, t, sc, tf in rep.csm_results]
    return out


def record_coarse_launches():
    """Wrap the coarse kernel's entry as the CSM engine calls it, so that
    each launch's inputs are kept; returns (launches, undo)."""
    from nautilus_tpu_torch.kernels import csm
    original = csm.fused_coarse
    launches = []

    def recording(parked, thetas, tables, **kw):
        launches.append((parked, thetas, tables, kw))
        return original(parked, thetas, tables, **kw)

    csm.fused_coarse = recording

    def undo():
        csm.fused_coarse = original
    return launches, undo
