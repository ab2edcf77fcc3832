"""Loop-closure pair gating by solution uncertainty (port of
nautilus_tpu/loop_closure/matcher.py).

- Covariance of two pose blocks under a temporary re-gauge (pose 0 freed,
  pose min(source, target) - 1 fixed): the (s, t) cross block of H^-1,
  its top-left 2x2 taken, from columns of the inverse of the gauged
  Gauss-Newton Hessian.  A band-eligible graph keeps H in block-band form
  (solve/band.py, O(N w) memory); any other graph takes a dense Cholesky
  of H [3M, 3M].
- Chi-square score: (t - s)^T Sigma^-1 (t - s) of the current translations.
- A pair passes the gate when its score is < 5000 (the reference's
  threshold).

Pairs sharing a gauge pose share one factorization and one multi-RHS solve
(an ``lc.gate.factor`` span each, utils/timer).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from nautilus_tpu_torch.solve.band import band_inverse_node_columns
from nautilus_tpu_torch.solve.factors import (BandedSystem, FactorGraph,
                                              assemble_banded_system,
                                              assemble_normal_equations)
from nautilus_tpu_torch.utils.timer import span

CHI_SQUARE_THRESHOLD = 5000.0


def _target_columns(targets):
    k3 = torch.arange(3, device=targets.device)
    return (3 * targets[:, None] + k3).reshape(-1)


def _extract_blocks(X, sources):
    """Top-left 2x2 of each pair's 3x3 cross block from the solved columns
    X [n_dof, 3K]."""
    dev = X.device
    X = X.reshape(X.shape[0], -1, 3)                          # [n_dof, K, 3]
    rows = 3 * sources[:, None] + torch.arange(3, device=dev)  # [K, 3]
    blocks = X[rows, torch.arange(sources.shape[0], device=dev)[:, None]]
    return blocks[:, :2, :2]


def _gauged_cholesky(H, fixed_pose: int):
    """(Cholesky factor, ok) of dense H gauged at ``fixed_pose``: its rows
    and columns zeroed with a unit diagonal, plus a Tikhonov term of 1e-8
    that guards the rank deficiency of unsolved or disconnected graphs."""
    n_dof = H.shape[0]
    fixed = (torch.arange(n_dof, device=H.device) // 3) == fixed_pose
    free = ~fixed
    Hg = H * (free[:, None] & free[None, :]).to(H.dtype)
    Hg = Hg + torch.diag(fixed.to(H.dtype) + 1e-8)
    chol, info = torch.linalg.cholesky_ex(Hg)
    return chol, info == 0


def _cross_cov_blocks(H, fixed_pose: int, sources, targets):
    """[K, 2, 2] cross-covariance blocks for pairs (sources[k], targets[k])
    from one dense factorization and one multi-RHS solve.  A failed
    factorization yields NaN blocks, which score infinite."""
    chol, ok = _gauged_cholesky(H, fixed_pose)
    cols = _target_columns(targets)
    rhs = (torch.arange(H.shape[0], device=H.device)[:, None]
           == cols[None, :]).to(H.dtype)
    X = torch.cholesky_solve(rhs, chol)                       # [n_dof, 3K]
    X = torch.where(ok, X, torch.full_like(X, float("nan")))
    return _extract_blocks(X, sources)


def _cross_cov_blocks_band(sys: BandedSystem, fixed_pose: int, sources,
                           targets):
    """Band-form twin of _cross_cov_blocks: one band factorization gauged
    at ``fixed_pose``; HITL line poses stay free."""
    n = sys.n
    fixed = torch.repeat_interleave(
        torch.arange(n + sys.num_lines, device=sys.diag.device) == fixed_pose,
        3)
    X = band_inverse_node_columns(sys, fixed, _target_columns(targets))
    return _extract_blocks(X, sources)


class LCMatcher:
    """Uncertainty gate over candidate pairs, sharing one Hessian.

    With ``layout`` the covariance solves run on the band: ``graph`` must
    then exclude long-range loop closures from its odometry batch, and they
    enter through ``lr`` as Woodbury columns.  Without one, ``graph`` holds
    every factor and H is dense.  ``from_solver`` picks."""

    def __init__(self, state, graph: FactorGraph, layout=None, lr=None):
        self.state = state
        x = torch.as_tensor(
            np.concatenate([state.solution, state.line_poses]),
            dtype=state.problem.points.dtype, device=state.problem.device)
        self._sys = self.H = None
        if layout is not None:
            self._sys, _ = assemble_banded_system(x, graph, layout, True, lr)
        else:
            self.H, _, _ = assemble_normal_equations(x, graph)
        self._pair_cache = {}

    @classmethod
    def from_solver(cls, solver, window: int = None) -> "LCMatcher":
        """Build from a Solver at the max window: the band engine when the
        solver's factor set is band-eligible, else the dense one."""
        x = solver._current_x()
        w = window if window is not None else \
            solver.config.get_int("lidar_constraint_amount_max")
        with span("lc.gate.build"):
            use_band = solver._band_eligible()
            graph = solver.build_graph(x, w, exclude_long_range=use_band)
            if use_band:
                return cls(solver.state, graph, layout=solver._layout,
                           lr=solver._long_range_factors())
            return cls(solver.state, graph)

    def chi_square_score(self, source: int, target: int
                         ) -> Tuple[np.ndarray, float]:
        return self._scores([(source, target)])[0]

    def _scores(self, pairs: List[Tuple[int, int]]):
        if not pairs:
            return []
        # Group by the re-gauge pose min(s, t) - 1 so each group shares one
        # factorization; pairs already scored come from the cache.
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for s, t in pairs:
            if (s, t) not in self._pair_cache:
                groups.setdefault(max(min(s, t) - 1, 0), []).append((s, t))
        dev = self.state.problem.device
        for fixed_pose, group in groups.items():
            with span("lc.gate.factor"):
                ss = torch.as_tensor([g[0] for g in group], device=dev)
                tt = torch.as_tensor([g[1] for g in group], device=dev)
                if self._sys is not None:
                    blocks = _cross_cov_blocks_band(self._sys, fixed_pose,
                                                    ss, tt)
                else:
                    blocks = _cross_cov_blocks(self.H, fixed_pose, ss, tt)
                blocks = blocks.cpu().numpy().astype(np.float64)
            if not np.all(np.isfinite(blocks)):
                warnings.warn(
                    f"the covariance factorization gauged at pose "
                    f"{fixed_pose} failed; its {len(group)} pairs score "
                    "infinite", stacklevel=2)
            for k, (s, t) in enumerate(group):
                cov = blocks[k]
                delta = self.state.solution[t, :2] - self.state.solution[s, :2]
                try:
                    score = float(delta @ np.linalg.inv(cov) @ delta)
                except np.linalg.LinAlgError:
                    score = float("inf")
                if not np.isfinite(score):
                    score = float("inf")
                self._pair_cache[(s, t)] = (cov, score)
        return [self._pair_cache[(s, t)] for s, t in pairs]

    def get_possible_matches(self, source: int, candidates: List[int],
                             threshold: float = CHI_SQUARE_THRESHOLD
                             ) -> List[int]:
        pairs = [(source, t) for t in candidates if t != source]
        scored = self._scores(pairs)
        return [t for (s, t), (_, score) in zip(pairs, scored)
                if score < threshold]
