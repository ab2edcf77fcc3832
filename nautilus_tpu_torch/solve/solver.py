"""High-level solver: the growing-window sweep over band LM solves (port of
nautilus_tpu/solve/solver.py, band path).

- ``solve_slam``: for each window size from lidar_constraint_amount_min to
  _max, associate planar and edge features at the current solution and run
  LM on the block-band system (the JAX package's fused sweep, as a Python
  loop over windows).
- ``solve_max_window``: one solve at the max window, used after loop
  closures are applied.

The dof vector is [solution; line_poses]: N node poses, then one free line
pose per HITL constraint (L of them, no padding).  Pose 0 is the gauge.

Only band-eligible graphs are ported: every odometry factor within the
window band, long-range loop closures as Woodbury columns (up to
lr_factor_cap).  Anything else raises NotImplementedError naming the
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.solve import correspond
from nautilus_tpu_torch.solve.factors import (BandLayout, FactorGraph,
                                              HitlFactors, OdomFactors,
                                              make_odom_factors)
from nautilus_tpu_torch.solve.lm import LMParams, LMResult, lm_solve_banded


@dataclasses.dataclass
class WindowStats:
    window: int
    initial_cost: float
    final_cost: float
    iterations: int
    wall_s: float


@dataclasses.dataclass
class SolveStats:
    windows: List[WindowStats] = dataclasses.field(default_factory=list)

    @property
    def final_cost(self) -> float:
        return self.windows[-1].final_cost if self.windows else float("nan")

    @property
    def total_wall_s(self) -> float:
        return sum(w.wall_s for w in self.windows)


def odom_factors_from_state(state: SLAMState, tw, rw, device,
                            dtype=torch.float32,
                            lc_factors=None) -> OdomFactors:
    """Active odometry factors + the given loop-closure factors (default:
    all of state.lc_factors), with their weights, on ``device``."""
    i, j, trans, rot = state.odometry_factors
    lc = state.lc_factors if lc_factors is None else lc_factors
    f = len(i)
    wt = np.full(f + len(lc), float(tw))
    wr = np.full(f + len(lc), float(rw))
    ii, jj = list(np.asarray(i)), list(np.asarray(j))
    tt, rr = list(np.asarray(trans, np.float64)), list(np.asarray(rot))
    for k, (li, lj, ltrans, lrot, lwt, lwr) in enumerate(lc):
        ii.append(li)
        jj.append(lj)
        tt.append(np.asarray(ltrans, np.float64))
        rr.append(lrot)
        wt[f + k], wr[f + k] = lwt, lwr
    return make_odom_factors(np.asarray(ii, np.int64), np.asarray(jj, np.int64),
                             np.asarray(tt, np.float64).reshape(-1, 2),
                             np.asarray(rr, np.float64), wt, wr, device, dtype)


class Solver:
    """Owns the optimization lifecycle for one SLAMState on its device."""

    # Long-range closures solve as Woodbury columns (3 per closure); past
    # this many the JAX package falls back to the dense path.
    LR_FACTOR_CAP = 341

    def __init__(self, state: SLAMState, config,
                 lm_params: Optional[LMParams] = None,
                 linear_solver: str = "auto"):
        """linear_solver: 'band' or 'auto' (= band when eligible).  The
        dense and CG solvers are not ported."""
        self.state = state
        self.config = config
        self.device = state.problem.device
        self.lm_params = lm_params or LMParams(
            step_tolerance=float(
                config.get("accuracy_change_stop_threshold", 0.0)),
            step_dof=3 * state.num_nodes)
        self.linear_solver = linear_solver
        n = state.num_nodes
        w_max = config.get_int("lidar_constraint_amount_max")
        self.pairs = correspond.make_pairs(n, w_max)
        self._pair_src = torch.as_tensor(self.pairs.src, device=self.device)
        self._pair_tgt = torch.as_tensor(self.pairs.tgt, device=self.device)
        w_eff = min(w_max, n - 1)
        self._layout = BandLayout(n, w_eff) if w_eff >= 1 else None

    # -- graph construction -------------------------------------------------

    def _split_lc(self):
        """state.lc_factors split into (in-band, long-range) by delta."""
        w = self._layout.w if self._layout is not None else 0
        in_b, lr = [], []
        for f in self.state.lc_factors:
            (in_b if abs(int(f[0]) - int(f[1])) <= w else lr).append(f)
        return in_b, lr

    def _odom_within_band(self) -> bool:
        if self._layout is None:
            return False
        i, j, _, _ = self.state.odometry_factors
        max_d = int(np.max(np.abs(np.asarray(i) - np.asarray(j)))) \
            if len(i) else 0
        return max_d <= self._layout.w

    def _band_eligible(self) -> bool:
        if not self._odom_within_band():
            return False
        cap = int(self.config.get("lr_factor_cap", self.LR_FACTOR_CAP))
        return len(self._split_lc()[1]) <= cap

    def _resolve_solver(self) -> str:
        if self.linear_solver not in ("auto", "band"):
            raise NotImplementedError(
                f"linear_solver={self.linear_solver!r} is not ported yet "
                "(ROADMAP.md section 1, 'dense fallback' / 'CG')")
        if not self._band_eligible():
            if self.linear_solver == "band":
                # An out-of-band block has no slot in the band: refuse
                # rather than drop the coupling.
                raise ValueError(
                    "linear_solver='band' requires >= 2 nodes, every "
                    "odometry factor within |i - j| <= window max, and at "
                    "most LR_FACTOR_CAP long-range loop-closure factors")
            raise NotImplementedError(
                "this graph is not band-eligible and needs the dense or CG "
                "solver, which is not ported yet (ROADMAP.md section 1, "
                "'dense fallback')")
        return "band"

    def _current_x(self) -> torch.Tensor:
        """[N + L, 3] dof vector: node poses, then HITL line poses."""
        x = np.concatenate([self.state.solution, self.state.line_poses])
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _fixed_mask(self) -> torch.Tensor:
        n_dof = 3 * (self.state.num_nodes + len(self.state.line_poses))
        mask = torch.zeros((n_dof,), dtype=torch.bool, device=self.device)
        mask[0:3] = True  # gauge: pose 0 constant
        return mask

    def _odom_factors(self) -> OdomFactors:
        """Odometry + in-band loop-closure factors (long-range closures go
        to _long_range_factors)."""
        cfg = self.config
        return odom_factors_from_state(self.state, cfg.translation_weight,
                                       cfg.rotation_weight, self.device,
                                       lc_factors=self._split_lc()[0])

    def _long_range_factors(self) -> Optional[OdomFactors]:
        """Long-range loop closures for the Woodbury term (None if none)."""
        _, lr = self._split_lc()
        if not lr:
            return None
        return make_odom_factors(
            [int(f[0]) for f in lr], [int(f[1]) for f in lr],
            np.asarray([f[2] for f in lr], np.float64),
            np.asarray([f[3] for f in lr], np.float64),
            np.asarray([f[4] for f in lr], np.float64),
            np.asarray([f[5] for f in lr], np.float64), self.device)

    def _hitl_factors(self) -> Optional[HitlFactors]:
        if not self.state.hitl_constraints:
            return None
        from nautilus_tpu_torch.solve.hitl import build_hitl_factors
        return build_hitl_factors(self.state)

    def build_graph(self, x, window, optimization_type: str = "feature",
                    odom: Optional[OdomFactors] = None,
                    hitl: Optional[HitlFactors] = None) -> FactorGraph:
        """Factor graph at x [N + L, 3] for one window size: planar matches
        feed normal residuals, edge matches point residuals, HITL rows
        point-to-segment residuals (built from the state unless given)."""
        if optimization_type != "feature":
            raise NotImplementedError(
                f"optimization_type={optimization_type!r} is not ported yet "
                "(ROADMAP.md section 1, 'associate_chunked')")
        cfg = self.config
        problem = self.state.problem
        outlier = float(cfg.outlier_threshold)
        args = (problem, x[:problem.num_nodes], self._pair_src,
                self._pair_tgt, window, outlier)
        planar = correspond.associate(*args, feature="planar")
        edge = correspond.associate(*args, feature="edge")
        return FactorGraph(odom=self._odom_factors() if odom is None else odom,
                           planar=planar, edge=edge,
                           hitl=self._hitl_factors() if hitl is None else hitl)

    # -- solving ------------------------------------------------------------

    def _solve_windows(self, w_min: int, w_max: int) -> SolveStats:
        self._resolve_solver()
        stats = SolveStats()
        x = self._current_x()
        fixed = self._fixed_mask()
        odom = self._odom_factors()
        lr = self._long_range_factors()
        hitl = self._hitl_factors()
        for window in range(w_min, w_max + 1):
            t0 = time.perf_counter()
            graph = self.build_graph(x, window, odom=odom, hitl=hitl)
            res: LMResult = lm_solve_banded(
                x, graph, fixed, params=self.lm_params, layout=self._layout,
                lr=lr)
            x = res.x
            if not bool(torch.all(torch.isfinite(x))):
                raise FloatingPointError(
                    f"Non-finite poses after window {window}; "
                    f"check odometry/scan inputs.")
            stats.windows.append(WindowStats(
                window=window, initial_cost=res.initial_cost,
                final_cost=res.cost, iterations=res.iterations,
                wall_s=time.perf_counter() - t0))
        self._writeback(x)
        return stats

    def solve_slam(self, optimization_type: str = "feature") -> SolveStats:
        """Full growing-window solve; updates state.solution in place."""
        if optimization_type != "feature":
            raise NotImplementedError(
                f"optimization_type={optimization_type!r} is not ported yet "
                "(ROADMAP.md section 1, 'associate_chunked')")
        cfg = self.config
        return self._solve_windows(cfg.get_int("lidar_constraint_amount_min"),
                                   cfg.get_int("lidar_constraint_amount_max"))

    def solve_max_window(self) -> SolveStats:
        """One solve at the max window size (after loop closures are
        injected)."""
        w = self.config.get_int("lidar_constraint_amount_max")
        return self._solve_windows(w, w)

    def _writeback(self, x):
        host = x.detach().cpu().numpy().astype(np.float64)
        n = self.state.num_nodes
        self.state.solution = host[:n]
        self.state.line_poses = host[n:]
