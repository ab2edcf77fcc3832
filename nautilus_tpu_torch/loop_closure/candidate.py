"""Loop-closure candidate filter (port of
nautilus_tpu/loop_closure/candidate.py).

A node is a candidate when it is >= 5 m from the previously accepted
candidate and its scan's scatter score lambda_min / lambda_max is >= 0.70
(geometric spread in both axes).  Scores for all nodes come from one batched
device pass; the spacing chain is a host loop.
"""

from __future__ import annotations

from typing import List

import numpy as np

from nautilus_tpu_torch.core import geometry as geo
from nautilus_tpu_torch.core.problem import SLAMState


def get_lc_candidates(state: SLAMState, min_distance: float = 5.0,
                      score_threshold: float = 0.70) -> List[int]:
    """Candidate node indices (defaults = the reference's 5 m / 0.70)."""
    scores = geo.scatter_matrix_score(state.problem.points,
                                      state.problem.points_mask).cpu().numpy()
    candidates: List[int] = []
    for i in range(state.num_nodes):
        if candidates:
            last = state.solution[candidates[-1], :2]
            if np.linalg.norm(state.solution[i, :2] - last) < min_distance:
                continue
        if scores[i] >= score_threshold:
            candidates.append(i)
    return candidates
