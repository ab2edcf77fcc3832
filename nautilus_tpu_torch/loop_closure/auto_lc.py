"""Automatic loop closure (port of nautilus_tpu/loop_closure/auto_lc.py:
``solve_auto_lc`` and its helpers).

1. candidate filter (scatter score + spacing), optionally the
   local-uncertainty criterion (keyframe_local_uncertainty_filtering);
2. range prefilter (lc_base_max_range + lc_max_range_scaling * |s - t|)
   and chi-square uncertainty gating over candidate pairs; on request
   (``use_descriptor_gate``) a scan-descriptor gate after it, scored by the
   learned embedding or the hand descriptor (``descriptor_gate``);
3. correlative scan matching per gated pair, each pair's target widened to
   its +-lc_match_window_size trajectory neighbours (best member wins),
   accepted at csm_score_threshold; the stage engine on one device, the
   pair engine split over the ranks when the solver has a mesh;
4. each accepted match becomes a weighted relative-pose factor;
5. re-solve at the max window.

``apply=False`` stops after scoring (diagnostic only).  When the config key
``lc_debug_output_dir`` names an existing directory, every scored pair is
drawn into it (raw and aligned overlay).  A solver's visualizer is shown the
candidate scans and the gated pairs' covariances.

``best_scan_match`` is the reference's BestScanMatch: the best-scoring of a
list of scans for one source, on the pair engine.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match_batch,
                                            csm_match_pairs, wrap_angle)
from nautilus_tpu_torch.loop_closure.candidate import get_lc_candidates
from nautilus_tpu_torch.loop_closure.matcher import LCMatcher
from nautilus_tpu_torch.utils.timer import span


@dataclasses.dataclass
class AutoLCReport:
    candidates: List[int]
    gated_pairs: List[Tuple[int, int]]
    csm_results: List[Tuple[int, int, float, np.ndarray]]  # (s, t, score, [tx ty th])
    accepted: List[Tuple[int, int]]
    applied: bool = False
    # The re-solve's SolveStats when closures were applied, else None.
    resolve_stats: object = None
    # Which engine scan-matched the gated pairs: "stage" on one device,
    # "sharded pair" over the solver's mesh.
    csm_engine: str = ""


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


def _dump_pair_image(state, s: int, t: int, transform: np.ndarray,
                     score: float, debug_dir: str) -> None:
    """Debug picture of a candidate pair: the two raw scans, and scan s
    moved onto scan t by the match, as lc_<s>_<t>.png in debug_dir."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    out = Path(debug_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = [s, t]
    pts = state.problem.points[idx].cpu().numpy()
    msk = state.problem.points_mask[idx].cpu().numpy()
    pa, pb = pts[0][msk[0]], pts[1][msk[1]]
    c, sn = np.cos(transform[2]), np.sin(transform[2])
    pa_aligned = pa @ np.array([[c, sn], [-sn, c]]) + transform[:2]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
    ax1.plot(pa[:, 0], pa[:, 1], ".", ms=1, label=f"scan {s}")
    ax1.plot(pb[:, 0], pb[:, 1], ".", ms=1, label=f"scan {t}")
    ax1.set_title("raw")
    ax1.legend()
    ax2.plot(pa_aligned[:, 0], pa_aligned[:, 1], ".", ms=1)
    ax2.plot(pb[:, 0], pb[:, 1], ".", ms=1)
    ax2.set_title(f"aligned (score {score:.2f})")
    for ax in (ax1, ax2):
        ax.set_aspect("equal")
    fig.savefig(out / f"lc_{s:04d}_{t:04d}.png", dpi=100,
                bbox_inches="tight")
    plt.close(fig)


def best_scan_match(state, source: int, scans,
                    params: CSMParams = CSMParams()):
    """The best scan match for ``source`` among ``scans`` (itself left
    out), each search centred on the solution-implied relative heading.
    Returns (best score, best scan index, [tx, ty, theta]); (-inf, -1,
    zeros) when no other scan is given."""
    scans = [int(s) for s in scans if s != source]
    if not scans:
        return float("-inf"), -1, np.zeros(3)
    pts, msk = state.problem.points, state.problem.points_mask
    tt = np.asarray(scans, np.int64)
    centers = wrap_angle(state.solution[source, 2] - state.solution[tt, 2])
    ss = torch.full((len(scans),), source, device=pts.device)
    tt_dev = torch.as_tensor(tt, device=pts.device)
    scores, transforms = csm_match_batch(
        pts[ss], msk[ss], pts[tt_dev], msk[tt_dev], params,
        rotation_centers=torch.as_tensor(centers.astype(np.float32),
                                         device=pts.device))
    scores = scores.cpu().numpy()
    k = int(np.argmax(scores))
    return float(scores[k]), scans[k], transforms[k].cpu().numpy()


def scorer_self_check(state, score_fn, n_probe: int = 12,
                      far_frac: float = 0.6):
    """AUC of ``score_fn`` on pairs whose label this map already knows.

    Near pairs: trajectory-adjacent nodes.  Far pairs: nodes whose solution
    distance exceeds ``far_frac`` of the map extent, almost surely far
    whatever the drift.  Returns P(score(near) > score(far)) over up to
    n_probe pairs per class, or None when the map is too small or compact
    to build both classes.
    """
    n = state.num_nodes
    if n < 6:
        return None
    sol = np.asarray(state.solution[:n, :2])
    extent = float(np.linalg.norm(sol.max(0) - sol.min(0)))
    if extent <= 1e-6:
        return None
    rng = np.random.default_rng(0)
    # Far pairs from one distance row per source node, not an N x N matrix.
    # Sources start at the bounding box's extremes: the wider axis's extreme
    # pair is at least extent / sqrt(2) apart, so for far_frac <= 0.7 a far
    # pair is found whenever one exists.
    span = sol.max(0) - sol.min(0)
    a = int(span[1] > span[0])
    seeds = [int(np.argmin(sol[:, a])), int(np.argmax(sol[:, a])),
             int(np.argmin(sol[:, 1 - a])), int(np.argmax(sol[:, 1 - a]))]
    seeds += [int(s) for s in rng.integers(0, n, 32)]
    far_pairs, seen_far = [], set()
    node_idx = np.arange(n)
    for s in seeds:
        if len(far_pairs) >= n_probe:
            break
        d = np.linalg.norm(sol - sol[s], axis=1)
        js = np.nonzero((d >= far_frac * extent)
                        & (np.abs(node_idx - s) >= 2))[0]
        for j in js[np.argsort(-d[js])[:4]]:
            key = (min(s, int(j)), max(s, int(j)))
            if key not in seen_far:
                seen_far.add(key)
                far_pairs.append((s, int(j)))
    far_pairs = far_pairs[:n_probe]
    if not far_pairs:
        return None
    near_i = rng.choice(n - 1, size=min(n_probe, n - 1), replace=False)
    near = np.array([float(score_fn(int(i), int(i + 1))) for i in near_i])
    far = np.array([float(score_fn(i, j)) for i, j in far_pairs])
    return float(np.mean(near[:, None] > far[None, :]))


def descriptor_gate(state, pairs, threshold: float,
                    use_learned_embedding: bool = None, weights_path=None):
    """The pairs whose scan-descriptor similarity reaches ``threshold``
    (config lc_match_threshold).  weights_path: the embedding's weights
    file (default: the package's shipped weights), e.g. one that
    ``python -m nautilus_tpu_torch.loop_closure.embedding --out`` wrote.

    use_learned_embedding (config lc_use_learned_embedding) True or False
    forces the scorer.  On None, with the weights file present, both
    scorers run scorer_self_check on this map, and the learned embedding
    scores only when it separates near from far pairs at least as well as
    the hand descriptor.  The choice and both AUCs are kept on the state
    (``_descriptor_gate_choice``) for later calls."""
    from nautilus_tpu_torch.loop_closure import embedding
    from nautilus_tpu_torch.loop_closure.learned import match_score
    pts = state.problem.points
    msk = state.problem.points_mask
    params = None
    if use_learned_embedding is None or use_learned_embedding:
        params = embedding.load_params(weights_path, device=pts.device,
                                       dtype=pts.dtype)
        if params is None and use_learned_embedding:
            raise FileNotFoundError(
                f"lc_use_learned_embedding=true but no weights at "
                f"{weights_path or embedding.default_weights_path()}")
    if not pairs:
        return []
    emb_score = (lambda s, t: embedding.embedding_match_score(
        params, pts[s], msk[s], pts[t], msk[t])) if params else None
    hand_score = lambda s, t: match_score(pts[s], msk[s], pts[t], msk[t])
    scorer = "emb" if params else "hand"
    if params is not None and use_learned_embedding is None:
        # The check depends only on the map's scans: run it once per state.
        kept = getattr(state, "_descriptor_gate_choice", None)
        if kept is None:
            auc_emb = scorer_self_check(state, emb_score)
            auc_hand = scorer_self_check(state, hand_score)
            kept = {"scorer": ("hand" if auc_emb is not None
                               and auc_hand is not None
                               and auc_emb < auc_hand else "emb"),
                    "auc_emb": auc_emb, "auc_hand": auc_hand}
            state._descriptor_gate_choice = kept
        scorer = kept["scorer"]
    score = hand_score if scorer == "hand" else emb_score
    return [(s, t) for s, t in pairs if float(score(s, t)) >= threshold]


def match_gated_pairs(state, gated_pairs, params: CSMParams, match_w: int,
                      engine: str = "stage", mesh=None):
    """Scan-match each gated pair (s, t) against t's +-match_w trajectory
    neighbours; the best-scoring member wins.  Rotation searches are
    centred on the solution-implied relative heading, so reverse
    traversals (~pi) are inside the window.

    Returns (scores [K], transforms [K, 3], best targets [K], number of
    window-expanded pairs matched); ``engine`` picks csm_match_pairs'
    engine.  With a ``mesh`` the pair list is split over its ranks, each
    running the pair engine (parallel.sharded.csm_match_pairs_sharded), as
    the JAX package does with a mesh."""
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
    if mesh is not None:
        from nautilus_tpu_torch.parallel.sharded import \
            csm_match_pairs_sharded
        all_scores, all_transforms = csm_match_pairs_sharded(
            state.problem.points, state.problem.points_mask, ss, tt, mesh,
            params, rotation_centers=centers)
    else:
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
    state = solver.state
    cfg = solver.config
    report = AutoLCReport(candidates=[], gated_pairs=[], csm_results=[],
                          accepted=[])

    # The four stage spans (lc.candidates, lc.gate, lc.csm, lc.resolve)
    # each end right after a host read of their results.
    with span("lc.candidates"):
        candidates = get_lc_candidates(state)
        if cfg.get("keyframe_local_uncertainty_filtering", False):
            from nautilus_tpu_torch.loop_closure.keyframes import (
                candidate_uncertainty_ok)
            ok = candidate_uncertainty_ok(state, cfg, candidates)
            candidates = [c for c, o in zip(candidates, ok) if o]
    report.candidates = candidates
    if verbose:
        print(f"Auto-LC: {len(candidates)} candidate scans.")
    if solver.visualizer is not None:
        solver.visualizer.draw_scans(state, candidates)
    if len(candidates) < 2:
        return report

    with span("lc.gate"):
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
            within = [int(t)
                      for t in cand_arr[(d <= limit) & (cand_arr != s)]]
            if not within:
                continue
            for t in matcher.get_possible_matches(s, within):
                key = (min(s, t), max(s, t))
                if key not in seen:
                    seen.add(key)
                    report.gated_pairs.append(key)
    if verbose:
        print(f"Auto-LC: {len(report.gated_pairs)} pairs pass the "
              f"chi-square gate.")
    if solver.visualizer is not None and report.gated_pairs:
        solver.visualizer.draw_covariances(
            [(t, matcher.chi_square_score(s, t)[0])
             for s, t in report.gated_pairs])
    if use_descriptor_gate and report.gated_pairs:
        report.gated_pairs = descriptor_gate(
            state, report.gated_pairs,
            float(cfg.get("lc_match_threshold", 0.5)),
            use_learned_embedding=cfg.get("lc_use_learned_embedding", None))
        if verbose:
            print(f"Auto-LC: {len(report.gated_pairs)} pairs pass the "
                  f"descriptor gate.")
    if not report.gated_pairs:
        return report

    mesh = solver.mesh
    report.csm_engine = "stage" if mesh is None else "sharded pair"
    with span("lc.csm"):
        scores, transforms, best_tt, _ = match_gated_pairs(
            state, report.gated_pairs,
            csm_params or _csm_params_from_config(cfg),
            int(cfg.get("lc_match_window_size", 0)), mesh=mesh)
    threshold = float(cfg.csm_score_threshold)
    wt = float(cfg.lc_translation_weight)
    wr = float(cfg.lc_rotation_weight)
    # Pair pictures only when the user made the directory: the key always
    # has a default value.
    debug_dir = cfg.get("lc_debug_output_dir", "")
    debug_dir = debug_dir if debug_dir and Path(debug_dir).is_dir() else ""
    for k, (s, _) in enumerate(report.gated_pairs):
        t = int(best_tt[k])
        report.csm_results.append((s, t, float(scores[k]), transforms[k]))
        if debug_dir:
            _dump_pair_image(state, s, t, transforms[k], float(scores[k]),
                             debug_dir)
        if scores[k] >= threshold:
            report.accepted.append((s, t))
            if apply:
                state.lc_factors.append(
                    relative_pose_factor(state, s, t, transforms[k], wt, wr))
    if verbose:
        print(f"Auto-LC: {len(report.accepted)} matches above CSM score "
              f"threshold ({threshold}).")
    if apply and report.accepted:
        with span("lc.resolve"):
            report.resolve_stats = solver.solve_max_window()
        report.applied = True
    return report
