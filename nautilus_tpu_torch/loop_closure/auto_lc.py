"""Automatic loop closure (port of nautilus_tpu/loop_closure/auto_lc.py:
``solve_auto_lc`` and its helpers).

1. candidate filter (scatter score + spacing), optionally the
   local-uncertainty criterion (keyframe_local_uncertainty_filtering);
2. range prefilter (lc_base_max_range + lc_max_range_scaling * |s - t|)
   and chi-square uncertainty gating over candidate pairs;
3. correlative scan matching per gated pair, each pair's target widened to
   its +-lc_match_window_size trajectory neighbours (best member wins),
   accepted at csm_score_threshold;
4. each accepted match becomes a weighted relative-pose factor;
5. re-solve at the max window.

``apply=False`` stops after scoring (diagnostic only).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np

from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match_pairs,
                                            wrap_angle)
from nautilus_tpu_torch.loop_closure.candidate import get_lc_candidates
from nautilus_tpu_torch.loop_closure.matcher import LCMatcher


@dataclasses.dataclass
class AutoLCReport:
    candidates: List[int]
    gated_pairs: List[Tuple[int, int]]
    csm_results: List[Tuple[int, int, float, np.ndarray]]  # (s, t, score, [tx ty th])
    accepted: List[Tuple[int, int]]
    applied: bool = False
    # Wall seconds per stage: candidates / gate / csm / resolve.
    stage_walls: dict = dataclasses.field(default_factory=dict)


def _csm_params_from_config(cfg) -> CSMParams:
    scan_range = float(cfg.max_lidar_range)
    if scan_range <= 0:
        scan_range = 30.0
    return CSMParams(scan_range=scan_range, trans_range=2.0,
                     low_res=0.3, high_res=0.01,
                     rotation_restriction=float(np.pi / 2))


def relative_pose_factor(state, s: int, t: int, transform: np.ndarray,
                         wt: float, wr: float):
    """A CSM transform (cloud s -> cloud t frame, p_t = R p_s + [tx, ty])
    as a factor tuple (i, j, trans, rot, wt, wr): the world-frame delta
    between pose min(s, t) and the other pose, with s placed at the pose
    the match implies (T_t o T_csm)."""
    i, j = (s, t) if s < t else (t, s)
    pose_t = state.solution[t]
    c, sn = np.cos(pose_t[2]), np.sin(pose_t[2])
    Rt = np.array([[c, -sn], [sn, c]])
    implied_s_loc = pose_t[:2] + Rt @ transform[:2]
    implied_s_rot = pose_t[2] + transform[2]
    implied = {s: np.array([implied_s_loc[0], implied_s_loc[1],
                            implied_s_rot]),
               t: pose_t}
    trans = implied[j][:2] - implied[i][:2]
    rot = implied[j][2] - implied[i][2]
    return (i, j, trans, float(rot), wt, wr)


def match_gated_pairs(state, gated_pairs, params: CSMParams, match_w: int,
                      engine: str = "stage"):
    """Scan-match each gated pair (s, t) against t's +-match_w trajectory
    neighbours; the best-scoring member wins.  Rotation searches are
    centred on the solution-implied relative heading, so reverse
    traversals (~pi) are inside the window.

    Returns (scores [K], transforms [K, 3], best targets [K], number of
    window-expanded pairs matched); ``engine`` picks csm_match_pairs'
    engine."""
    n_nodes = state.num_nodes
    exp_ss, exp_tt, owner = [], [], []
    for k, (s, t) in enumerate(gated_pairs):
        for dt in range(-match_w, match_w + 1):
            t2 = t + dt
            if 0 <= t2 < n_nodes and t2 != s:
                exp_ss.append(s)
                exp_tt.append(t2)
                owner.append(k)
    ss, tt = np.asarray(exp_ss, np.int64), np.asarray(exp_tt, np.int64)
    centers = wrap_angle(state.solution[ss, 2] - state.solution[tt, 2])
    all_scores, all_transforms = csm_match_pairs(
        state.problem.points, state.problem.points_mask, ss, tt, params,
        rotation_centers=centers, engine=engine)
    all_transforms = np.asarray(all_transforms, np.float64)
    scores = np.full(len(gated_pairs), -np.inf)
    transforms = np.zeros((len(gated_pairs), 3))
    best_tt = np.array([t for _, t in gated_pairs], np.int64)
    for j in range(len(ss)):
        k = owner[j]
        if all_scores[j] > scores[k]:
            scores[k] = all_scores[j]
            transforms[k] = all_transforms[j]
            best_tt[k] = tt[j]
    return scores, transforms, best_tt, len(ss)


def solve_auto_lc(solver, apply: bool = True, verbose: bool = True,
                  csm_params: CSMParams = None,
                  use_descriptor_gate: bool = False) -> AutoLCReport:
    """Full auto-LC pass over the solver's state."""
    if use_descriptor_gate:
        raise NotImplementedError(
            "the descriptor gate is not ported yet (ROADMAP.md section 1, "
            "'embedding and descriptor gate')")
    state = solver.state
    cfg = solver.config
    report = AutoLCReport(candidates=[], gated_pairs=[], csm_results=[],
                          accepted=[])

    t0 = time.perf_counter()
    candidates = get_lc_candidates(state)
    if cfg.get("keyframe_local_uncertainty_filtering", False):
        from nautilus_tpu_torch.loop_closure.keyframes import (
            candidate_uncertainty_ok)
        ok = candidate_uncertainty_ok(state, cfg, candidates)
        candidates = [c for c, o in zip(candidates, ok) if o]
    report.candidates = candidates
    report.stage_walls["candidates"] = time.perf_counter() - t0
    if verbose:
        print(f"Auto-LC: {len(candidates)} candidate scans.")
    if len(candidates) < 2:
        return report

    t0 = time.perf_counter()
    matcher = LCMatcher.from_solver(solver)
    base_range = float(cfg.get("lc_base_max_range", 3.5))
    range_scaling = float(cfg.get("lc_max_range_scaling", 0.01))
    pos = np.asarray(state.solution[:, :2])
    cand_arr = np.asarray(candidates, np.int64)
    cand_pos = pos[cand_arr]
    seen = set()
    for idx, s in enumerate(candidates):
        d = np.linalg.norm(cand_pos - cand_pos[idx], axis=1)
        limit = base_range + range_scaling * np.abs(cand_arr - s)
        within = [int(t) for t in cand_arr[(d <= limit) & (cand_arr != s)]]
        if not within:
            continue
        for t in matcher.get_possible_matches(s, within):
            key = (min(s, t), max(s, t))
            if key not in seen:
                seen.add(key)
                report.gated_pairs.append(key)
    report.stage_walls["gate"] = time.perf_counter() - t0
    if verbose:
        print(f"Auto-LC: {len(report.gated_pairs)} pairs pass the "
              f"chi-square gate.")
    if not report.gated_pairs:
        return report

    t0 = time.perf_counter()
    scores, transforms, best_tt, _ = match_gated_pairs(
        state, report.gated_pairs, csm_params or _csm_params_from_config(cfg),
        int(cfg.get("lc_match_window_size", 0)))
    threshold = float(cfg.csm_score_threshold)
    wt = float(cfg.lc_translation_weight)
    wr = float(cfg.lc_rotation_weight)
    for k, (s, _) in enumerate(report.gated_pairs):
        t = int(best_tt[k])
        report.csm_results.append((s, t, float(scores[k]), transforms[k]))
        if scores[k] >= threshold:
            report.accepted.append((s, t))
            if apply:
                state.lc_factors.append(
                    relative_pose_factor(state, s, t, transforms[k], wt, wr))
    report.stage_walls["csm"] = time.perf_counter() - t0
    if verbose:
        print(f"Auto-LC: {len(report.accepted)} matches above CSM score "
              f"threshold ({threshold}).")
    if apply and report.accepted:
        t0 = time.perf_counter()
        solver.solve_max_window()
        report.stage_walls["resolve"] = time.perf_counter() - t0
        report.applied = True
    return report
