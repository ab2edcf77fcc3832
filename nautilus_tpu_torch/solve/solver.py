"""High-level solver: the growing-window sweep over LM solves (port of
nautilus_tpu/solve/solver.py).

- ``solve_slam``: for each window size from lidar_constraint_amount_min to
  _max, associate features at the current solution and run LM (the JAX
  package's sweep, as a Python loop over windows).  Optimization type
  "feature" matches planar and edge features; "all" matches whole clouds.
- ``solve_max_window``: one solve at the max window, used after loop
  closures are applied.

With a ``mesh`` (parallel/sharded.py) both run the factor-parallel sweep
for optimization type "feature": every rank associates and assembles its
slice of the factor lists and the controller sums them, on the band when
the resolved solver is "band" and densely otherwise ("cg" included: it has
no sharded engine in the JAX package either).

With a ``visualizer`` (viz/visualizer.py) the solver draws where the JAX
package's does: solve_slam draws the initial solution, then after each
window its solution and its planar and edge correspondences (over a mesh,
once at the end); solve_max_window draws its solution.
``per_iteration_viz`` also redraws after every LM step of the sweep, which
then runs on the dense route (lm_solve_stepped).

The dof vector is [solution; line_poses]: N node poses, then one free line
pose per HITL constraint (L of them, no padding).  Pose 0 is the gauge.
Solver state has the dtype of the problem's clouds (float32, or float64
for a solver_dtype=float64 problem).

Three linear solvers, resolved per solve because loop closures change the
factor set:
- "band": block-band Cholesky, when every odometry factor lies within the
  window band and at most lr_factor_cap long-range closures ride along as
  Woodbury columns;
- "dense": dense Cholesky on H [3M, 3M], any topology;
- "cg": matrix-free preconditioned CG, preconditioned by the band subset
  when the odometry is within the band.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.solve import correspond
from nautilus_tpu_torch.solve.factors import (BandLayout, Correspondences,
                                              FactorGraph, HitlFactors,
                                              OdomFactors, make_odom_factors)
from nautilus_tpu_torch.solve.lm import (LMParams, LMResult, lm_solve,
                                         lm_solve_banded, lm_solve_stepped)
from nautilus_tpu_torch.utils.timer import span


@dataclasses.dataclass
class WindowStats:
    window: int
    initial_cost: float
    final_cost: float
    iterations: int
    wall_s: float
    inner_iterations: int = 0   # CG iterations (linear solver 'cg' only)


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

    # 'auto' takes dense H up to this many nodes and CG beyond.  The JAX
    # package's figure, from three live (3N)^2 float32 copies on a 16 GB
    # TPU; kept for parity, not measured on the H100.
    DENSE_MAX_NODES = 8000

    def __init__(self, state: SLAMState, config, visualizer=None,
                 lm_params: Optional[LMParams] = None,
                 linear_solver: str = "auto",
                 use_normal_gate: bool = False,
                 per_iteration_viz: bool = False,
                 assembly: Optional[str] = None,
                 mesh=None):
        """visualizer: a viz.visualizer.SolverVisualizer the solves and
        auto-LC draw to (None: no drawing, and nothing copied for it).

        linear_solver: 'band', 'dense', 'cg', or 'auto' (band when
        eligible, else dense up to DENSE_MAX_NODES nodes, else cg).

        use_normal_gate: match a feature only to targets whose normal lies
        within 20 degrees of its own.

        per_iteration_viz: with a visualizer, redraw after every LM step of
        solve_slam's windows (the reference's per-iteration redraw); those
        windows then solve on the dense route, one host read of x per step.
        Without a visualizer it changes nothing.

        assembly: 'moments' or None for the moment-form band assembly (J^T J
        and J^T r from per-point scalar sums, J never formed), 'jacobian'
        for the closed-form J and its contraction.

        mesh: a parallel.sharded.Mesh on the problem's device.  When set,
        solve_slam and solve_max_window run the factor-parallel sweep for
        optimization type "feature", and auto-LC's CSM batch is split over
        the mesh.  Product surface: the config key ``mesh_devices`` or the
        CLI's ``--devices``."""
        if linear_solver not in ("auto", "band", "dense", "cg"):
            raise ValueError(f"linear_solver must be auto, band, dense or cg, "
                             f"got {linear_solver!r}")
        if assembly not in (None, "moments", "jacobian"):
            raise ValueError(f"assembly must be moments or jacobian, got "
                             f"{assembly!r}")
        self.state = state
        self.config = config
        self.visualizer = visualizer
        self.per_iteration_viz = per_iteration_viz and visualizer is not None
        self._viz_window = None
        self.device = state.problem.device
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh runs on {mesh.device}, the problem "
                             f"on {self.device}")
        self.mesh = mesh
        self.lm_params = lm_params or LMParams(
            step_tolerance=float(
                config.get("accuracy_change_stop_threshold", 0.0)),
            step_dof=3 * state.num_nodes)
        self.linear_solver = linear_solver
        # The linear solver the last solve resolved to.
        self.last_solver: Optional[str] = None
        self.use_normal_gate = use_normal_gate
        self.assembly = assembly
        n = state.num_nodes
        w_max = config.get_int("lidar_constraint_amount_max")
        with span("solver.init"):
            self.pairs = correspond.make_pairs(n, w_max)
            self._pair_src = torch.as_tensor(self.pairs.src,
                                             device=self.device)
            self._pair_tgt = torch.as_tensor(self.pairs.tgt,
                                             device=self.device)
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
        """This solve's linear solver ('auto' depends on the current factor
        set, which loop closures change)."""
        if self.linear_solver != "auto":
            if self.linear_solver == "band" and not self._band_eligible():
                # An out-of-band block has no slot in the band: refuse
                # rather than drop the coupling.
                raise ValueError(
                    "linear_solver='band' requires >= 2 nodes, every "
                    "odometry factor within |i - j| <= window max, and at "
                    "most LR_FACTOR_CAP long-range loop-closure factors: "
                    "use 'dense' or 'auto'")
            return self.linear_solver
        if self._band_eligible():
            return "band"
        return "dense" if self.state.num_nodes <= self.DENSE_MAX_NODES \
            else "cg"

    def _dtype(self) -> torch.dtype:
        return self.state.problem.points.dtype

    def _analytic_mode(self):
        """The band assembly's form: 'moments' unless assembly='jacobian'."""
        return True if self.assembly == "jacobian" else "moments"

    def _current_x(self) -> torch.Tensor:
        """[N + L, 3] dof vector: node poses, then HITL line poses."""
        x = np.concatenate([self.state.solution, self.state.line_poses])
        return torch.as_tensor(x, dtype=self._dtype(), device=self.device)

    def _fixed_mask(self) -> torch.Tensor:
        n_dof = 3 * (self.state.num_nodes + len(self.state.line_poses))
        mask = torch.zeros((n_dof,), dtype=torch.bool, device=self.device)
        mask[0:3] = True  # gauge: pose 0 constant
        return mask

    def _odom_factors(self, exclude_long_range: bool = False) -> OdomFactors:
        """Odometry + loop-closure factors.  With exclude_long_range only
        the in-band closures join; the long-range ones then go to
        _long_range_factors (the band path)."""
        cfg = self.config
        lc = self._split_lc()[0] if exclude_long_range else None
        return odom_factors_from_state(self.state, cfg.translation_weight,
                                       cfg.rotation_weight, self.device,
                                       self._dtype(), lc_factors=lc)

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
            np.asarray([f[5] for f in lr], np.float64), self.device,
            self._dtype())

    def _hitl_factors(self) -> Optional[HitlFactors]:
        if not self.state.hitl_constraints:
            return None
        from nautilus_tpu_torch.solve.hitl import build_hitl_factors
        return build_hitl_factors(self.state, self._dtype())

    def build_graph(self, x, window, optimization_type: str = "feature",
                    exclude_long_range: bool = False,
                    odom: Optional[OdomFactors] = None,
                    hitl: Optional[HitlFactors] = None) -> FactorGraph:
        """Factor graph at x [N + L, 3] for one window size.

        optimization_type 'feature': planar matches feed normal residuals,
        edge matches point residuals; 'all': whole clouds matched by nearest
        neighbour feed point residuals, 64 pairs at a time.  HITL rows feed
        point-to-segment residuals.  The odometry batch (with or without
        the long-range closures) and the HITL batch are built from the state
        unless given."""
        if optimization_type not in ("feature", "all"):
            raise ValueError(f"optimization_type must be feature or all, got "
                             f"{optimization_type!r}")
        cfg = self.config
        problem = self.state.problem
        outlier = float(cfg.outlier_threshold)
        xn = x[:problem.num_nodes]
        if odom is None:
            odom = self._odom_factors(exclude_long_range)
        if hitl is None:
            hitl = self._hitl_factors()
        if optimization_type == "all":
            full = correspond.associate_chunked(
                problem, xn, self.pairs, window, outlier, feature="all")
            empty = Correspondences(*[t[:0] for t in full])
            return FactorGraph(odom=odom, planar=empty, edge=full, hitl=hitl)
        args = (problem, xn, self._pair_src, self._pair_tgt, window, outlier)
        planar = correspond.associate(*args, feature="planar",
                                      use_normal_gate=self.use_normal_gate)
        edge = correspond.associate(*args, feature="edge",
                                    use_normal_gate=self.use_normal_gate)
        return FactorGraph(odom=odom, planar=planar, edge=edge, hitl=hitl)

    # -- solving ------------------------------------------------------------

    def _solve_windows(self, w_min: int, w_max: int,
                       optimization_type: str = "feature",
                       sweep: bool = True) -> SolveStats:
        """Solve windows w_min..w_max; ``sweep`` (solve_slam) draws the
        initial solution and each window's correspondences and steps with
        per_iteration_viz, as the JAX package's sweep does."""
        kind = self.last_solver = self._resolve_solver()
        vis = self.visualizer
        stepped = sweep and self.per_iteration_viz
        if self.mesh is not None:
            if optimization_type == "feature" and not stepped:
                stats = self._solve_sharded(kind, w_min, w_max)
                if vis is not None:
                    vis.draw_solution(self.state, window=w_max)
                return stats
            warnings.warn("mesh set but the requested mode needs the "
                          "single-device path (optimization type 'all' or "
                          "per-iteration viz); running single-device",
                          stacklevel=3)
        if stepped and kind == "band":
            kind = self.last_solver = "dense"
        stats = SolveStats()
        x = self._current_x()
        fixed = self._fixed_mask()
        if sweep and vis is not None:
            vis.draw_solution(self.state)
        # The band solves the long-range closures as Woodbury columns; dense
        # and CG hold them in the odometry batch.
        odom = self._odom_factors(exclude_long_range=kind == "band")
        lr = self._long_range_factors() if kind == "band" else None
        # CG's band preconditioner: the same graph with the long-range
        # closures left out, when the odometry itself is within the band.
        band_odom = (self._odom_factors(exclude_long_range=True)
                     if kind == "cg" and self._odom_within_band() else None)
        hitl = self._hitl_factors()
        for window in range(w_min, w_max + 1):
            t0 = time.perf_counter()
            # Ends after the isfinite read, so it holds the window's device
            # work.
            with span("solve.window"):
                graph = self.build_graph(x, window, optimization_type,
                                         odom=odom, hitl=hitl)
                if kind == "band":
                    res: LMResult = lm_solve_banded(
                        x, graph, fixed, params=self.lm_params,
                        layout=self._layout, lr=lr,
                        analytic=self._analytic_mode())
                elif kind == "cg":
                    from nautilus_tpu_torch.solve.cg import lm_solve_cg
                    bg = None if band_odom is None else \
                        graph._replace(odom=band_odom)
                    res = lm_solve_cg(
                        x, graph, fixed, params=self.lm_params, band_graph=bg,
                        layout=None if bg is None else self._layout)
                elif stepped:
                    self._viz_window = window
                    res = lm_solve_stepped(
                        x, graph, fixed, params=self.lm_params,
                        iteration_callback=self._iteration_viz,
                        layout=self._layout)
                else:
                    res = lm_solve(x, graph, fixed, params=self.lm_params,
                                   layout=self._layout)
                x = res.x
                if not bool(torch.all(torch.isfinite(x))):
                    raise FloatingPointError(
                        f"Non-finite poses after window {window}; "
                        f"check odometry/scan inputs.")
            stats.windows.append(WindowStats(
                window=window, initial_cost=res.initial_cost,
                final_cost=res.cost, iterations=res.iterations,
                wall_s=time.perf_counter() - t0,
                inner_iterations=res.inner_iterations))
            if vis is not None:
                self._writeback(x)
                vis.draw_solution(self.state, window=window)
                if sweep:
                    vis.draw_correspondence(graph.planar)
                    vis.draw_correspondence(graph.edge)
        self._writeback(x)
        return stats

    def _iteration_viz(self, x, cost, iteration):
        """lm_solve_stepped's callback: redraw after one LM step."""
        del cost, iteration
        self._writeback(x)
        self.visualizer.draw_solution(self.state, window=self._viz_window)

    def _solve_sharded(self, kind: str, w_min: int, w_max: int) -> SolveStats:
        """The sweep over self.mesh (parallel.sharded.sharded_sweep): band
        form with the long-range closures as Woodbury columns when the
        solver resolved to the band, dense form otherwise.  The band form
        takes the closed-form J, as the JAX package's sharded sweep does."""
        from nautilus_tpu_torch.parallel.sharded import sharded_sweep
        use_band = kind == "band"
        self.last_solver = "band" if use_band else "dense"
        t0 = time.perf_counter()
        x, initial, final, iterations = sharded_sweep(
            self._current_x(), self.state.problem, self._pair_src,
            self._pair_tgt, self._odom_factors(exclude_long_range=use_band),
            self._hitl_factors(), self._fixed_mask(),
            float(self.config.outlier_threshold), w_min, w_max, self.mesh,
            self.lm_params, self.use_normal_gate, use_band,
            self._long_range_factors() if use_band else None)
        if not bool(torch.all(torch.isfinite(x))):
            raise FloatingPointError("Non-finite poses after sharded solve; "
                                     "check odometry/scan inputs.")
        per = (time.perf_counter() - t0) / (w_max - w_min + 1)
        stats = SolveStats([
            WindowStats(window=w_min + k, initial_cost=float(initial[k]),
                        final_cost=float(final[k]),
                        iterations=int(iterations[k]), wall_s=per)
            for k in range(w_max - w_min + 1)])
        self._writeback(x)
        return stats

    def solve_slam(self, optimization_type: str = "feature") -> SolveStats:
        """Full growing-window solve; updates state.solution in place."""
        cfg = self.config
        return self._solve_windows(cfg.get_int("lidar_constraint_amount_min"),
                                   cfg.get_int("lidar_constraint_amount_max"),
                                   optimization_type)

    def solve_max_window(self,
                         optimization_type: str = "feature") -> SolveStats:
        """One solve at the max window size (after loop closures are
        injected)."""
        w = self.config.get_int("lidar_constraint_amount_max")
        return self._solve_windows(w, w, optimization_type, sweep=False)

    def _writeback(self, x):
        host = x.detach().cpu().numpy().astype(np.float64)
        n = self.state.num_nodes
        self.state.solution = host[:n]
        self.state.line_poses = host[n:]
