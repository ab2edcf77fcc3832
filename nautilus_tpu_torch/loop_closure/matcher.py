"""Loop-closure pair gating by solution uncertainty (port of
nautilus_tpu/loop_closure/matcher.py, band covariance engine).

- Covariance of two pose blocks under a temporary re-gauge (pose 0 freed,
  pose min(source, target) - 1 fixed): the (s, t) cross block of H^-1,
  its top-left 2x2 taken, from columns of the inverse of the gauged
  block-band Gauss-Newton Hessian (solve/band.py).
- Chi-square score: (t - s)^T Sigma^-1 (t - s) of the current translations.
- A pair passes the gate when its score is < 5000 (the reference's
  threshold).

Pairs sharing a gauge pose share one factorization and one multi-RHS solve.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nautilus_tpu_torch.solve.band import band_inverse_node_columns
from nautilus_tpu_torch.solve.factors import (BandedSystem, FactorGraph,
                                              assemble_banded_system)

CHI_SQUARE_THRESHOLD = 5000.0


def _cross_cov_blocks_band(sys: BandedSystem, fixed_pose: int, sources,
                           targets):
    """[K, 2, 2] cross-covariance blocks for pairs (sources[k], targets[k])
    from one band factorization gauged at ``fixed_pose``; HITL line poses
    stay free."""
    n = sys.n
    dev = sys.diag.device
    fixed = torch.repeat_interleave(
        torch.arange(n + sys.num_lines, device=dev) == fixed_pose, 3)
    k3 = torch.arange(3, device=dev)
    cols = (3 * targets[:, None] + k3).reshape(-1)
    X = band_inverse_node_columns(sys, fixed, cols)           # [3n, 3K]
    X = X.reshape(3 * n, -1, 3)                               # [3n, K, 3]
    rows = 3 * sources[:, None] + k3                          # [K, 3]
    blocks = X[rows, torch.arange(sources.shape[0], device=dev)[:, None]]
    return blocks[:, :2, :2]


class LCMatcher:
    """Uncertainty gate over candidate pairs, sharing one Hessian.

    ``graph`` must exclude long-range loop closures from its odometry batch;
    they enter through ``lr`` as Woodbury columns."""

    def __init__(self, state, graph: FactorGraph, layout, lr=None):
        self.state = state
        x = torch.as_tensor(
            np.concatenate([state.solution, state.line_poses]),
            dtype=torch.float32, device=state.problem.device)
        self._sys, _ = assemble_banded_system(x, graph, layout, True, lr)
        self._pair_cache = {}

    @classmethod
    def from_solver(cls, solver, window: int = None) -> "LCMatcher":
        """Build from a Solver at the max window (band engine)."""
        solver._resolve_solver()
        x = solver._current_x()
        w = window if window is not None else \
            solver.config.get_int("lidar_constraint_amount_max")
        return cls(solver.state, solver.build_graph(x, w), solver._layout,
                   lr=solver._long_range_factors())

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
        dev = self._sys.diag.device
        for fixed_pose, group in groups.items():
            ss = torch.as_tensor([g[0] for g in group], device=dev)
            tt = torch.as_tensor([g[1] for g in group], device=dev)
            blocks = _cross_cov_blocks_band(self._sys, fixed_pose, ss, tt)
            blocks = blocks.cpu().numpy().astype(np.float64)
            for k, (s, t) in enumerate(group):
                cov = blocks[k]
                delta = self.state.solution[t, :2] - self.state.solution[s, :2]
                try:
                    score = float(delta @ np.linalg.inv(cov) @ delta)
                except np.linalg.LinAlgError:
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
