"""Keyframe selection and the local-uncertainty criterion for automatic loop
closure (port of nautilus_tpu/loop_closure/keyframes.py).

The policy the config describes (keys ``keyframe_min_odom_distance``,
``keyframe_local_uncertainty_filtering`` with the ``local_uncertainty_*``
thresholds, ``keyframe_chi_squared_test`` and
``keyframe_chi_squared_confidence``): a node whose merged neighbourhood is
well conditioned becomes a keyframe when it moved far enough from the last
keyframe.  "Far enough" is the metric spacing, or, with the chi-squared
test, a translation that is significant under the odometry covariance
accumulated since the last keyframe: |delta|^2 tw^2 / steps above the exact
2-dof quantile -2 ln(1 - confidence), with tw = translation_weight.

Auto-LC applies only the uncertainty criterion, per candidate
(``candidate_uncertainty_ok``): its candidate filter keeps its own spacing.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.loop_closure.learned import local_uncertainty


def _merged_uncertainty(state: SLAMState, nodes, prev_scans: int):
    """(condition, scale) host arrays, one per node of ``nodes``: its scan
    merged with its ``prev_scans`` predecessors, moved into the node's frame
    through the current solution (predecessors before node 0 are masked)."""
    prob = state.problem
    dev = prob.device
    pts, msk, nrm = prob.points, prob.points_mask, prob.normals
    sol = torch.as_tensor(state.solution, dtype=pts.dtype, device=dev)
    node = torch.as_tensor(nodes, device=dev)
    th_i, t_i = sol[node, 2], sol[node, :2]
    c_i, s_i = torch.cos(th_i), torch.sin(th_i)
    pieces_p, pieces_m, pieces_n = [], [], []
    for s in range(prev_scans + 1):
        j = torch.clamp(node - s, min=0)
        pj, nj = pts[j], nrm[j]
        mj = msk[j] & (node >= s)[:, None]
        th_j, t_j = sol[j, 2], sol[j, :2]
        # node j frame -> world -> node i frame: R(-th_i)(R(th_j) p + t_j
        # - t_i); normals rotate by th_j - th_i.
        dth = th_j - th_i
        c, sn = torch.cos(dth)[:, None], torch.sin(dth)[:, None]
        px = c * pj[..., 0] - sn * pj[..., 1]
        py = sn * pj[..., 0] + c * pj[..., 1]
        dt = t_j - t_i
        dx = c_i[:, None] * dt[:, None, 0] + s_i[:, None] * dt[:, None, 1]
        dy = -s_i[:, None] * dt[:, None, 0] + c_i[:, None] * dt[:, None, 1]
        pieces_p.append(torch.stack([px + dx, py + dy], dim=-1))
        pieces_n.append(torch.stack([c * nj[..., 0] - sn * nj[..., 1],
                                     sn * nj[..., 0] + c * nj[..., 1]], dim=-1))
        pieces_m.append(mj)
    conds, scales = local_uncertainty(torch.cat(pieces_p, dim=1),
                                      torch.cat(pieces_m, dim=1),
                                      torch.cat(pieces_n, dim=1))
    return conds.cpu().numpy(), scales.cpu().numpy()


def _batched_local_uncertainty(state: SLAMState, prev_scans: int):
    """(condition, scale) of every node's merged neighbourhood
    (``local_uncertainty_prev_scans`` predecessors), one batched pass."""
    return _merged_uncertainty(state, np.arange(state.num_nodes), prev_scans)


def _thresholds(config):
    return (float(config.get("local_uncertainty_condition_threshold", 9.5)),
            float(config.get("local_uncertainty_scale_threshold", 2.5)),
            int(config.get("local_uncertainty_prev_scans", 2)))


def candidate_uncertainty_ok(state: SLAMState, config, nodes) -> np.ndarray:
    """Bool mask over ``nodes``: each node's scan, merged with its
    ``local_uncertainty_prev_scans`` predecessors in the node's frame (via
    the current solution), is well conditioned
    (condition < local_uncertainty_condition_threshold and
    scale < local_uncertainty_scale_threshold)."""
    idx = np.asarray(nodes, np.int64)
    if idx.size == 0:
        return np.zeros(0, bool)
    cond_thresh, scale_thresh, prev_scans = _thresholds(config)
    conds, scales = _merged_uncertainty(state, idx, prev_scans)
    return (conds < cond_thresh) & (scales < scale_thresh)


def select_keyframes(state: SLAMState, config) -> np.ndarray:
    """Bool mask [N] of the keyframe nodes under the config's policy."""
    n = state.num_nodes
    min_dist = float(config.get("keyframe_min_odom_distance", 0.5))
    use_chi2 = bool(config.get("keyframe_chi_squared_test", False))
    chi2_conf = float(config.get("keyframe_chi_squared_confidence", 0.95))
    # The odometry factors' weight: the per-step translation information's
    # square root (not lc_translation_weight, which weights closures).
    tw = float(config.get("translation_weight", 1.0))
    # The 2-dof chi-squared quantile in closed form: P(X <= q) = 1 - e^(-q/2).
    chi2_quantile = -2.0 * math.log(max(1.0 - chi2_conf, 1e-12))
    if bool(config.get("keyframe_local_uncertainty_filtering", True)):
        cond_thresh, scale_thresh, prev_scans = _thresholds(config)
        conds, scales = _batched_local_uncertainty(state, prev_scans)
        uncertainty_ok = (conds < cond_thresh) & (scales < scale_thresh)
    else:
        uncertainty_ok = np.ones(n, bool)

    keyframes = np.zeros(n, bool)
    last_loc = None
    last_idx = 0
    for i in range(n):
        if not uncertainty_ok[i]:
            continue
        loc = state.solution[i, :2]
        if last_loc is not None:
            delta2 = float(np.sum((loc - last_loc) ** 2))
            if use_chi2:
                steps = max(i - last_idx, 1)
                if delta2 * tw * tw / steps <= chi2_quantile:
                    continue
            elif delta2 < min_dist * min_dist:
                continue
        keyframes[i] = True
        last_loc = loc
        last_idx = i
    return keyframes


def keyframe_pairs(keyframes: np.ndarray,
                   min_keyframe_gap: int) -> List[tuple]:
    """All keyframe pairs at least ``min_keyframe_gap`` keyframes apart
    (config lc_min_keyframes)."""
    idx = np.where(keyframes)[0]
    return [(int(idx[a]), int(idx[b])) for a in range(len(idx))
            for b in range(a + min_keyframe_gap, len(idx))]
