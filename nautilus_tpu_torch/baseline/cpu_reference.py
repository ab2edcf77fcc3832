"""Ceres-parity CPU reference engine (numpy/scipy, float64); port of
nautilus_tpu/baseline/cpu_reference.py.

The reference publishes no benchmark numbers (BASELINE.md), so this module
is the measured CPU baseline: a faithful reimplementation of the reference's
solve pipeline — KD-tree correspondence search (scipy.cKDTree standing in
for src/util/kdtree.cc), analytic-Jacobian residuals (same semantics as
src/optimization/slam_residuals.h), sparse normal equations via scipy
(standing in for Ceres SPARSE_SCHUR, solver.cc:269), and the same
Levenberg-Marquardt trust-region schedule as solve/lm.py (which itself
mirrors Ceres defaults).  Runs in float64 like Ceres.

It shares no code with the port's solver: only
``CpuProblem.from_device_problem`` touches a tensor, and it copies the
port's ``SLAMProblem`` (on any device) to host float64.  Used for the <=1%
final-cost bar against the port's solves and HITL step
(tests/test_torch_baseline.py; chip_smoke.py phase 17).  ``hitl_rows`` and
``CpuSolveStats.line_poses`` are additions to the JAX module: they let a
caller score another engine's HITL result under this engine's cost.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.spatial import cKDTree


def _rot(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _drot(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[-s, -c], [c, -s]])


@dataclasses.dataclass
class CpuProblem:
    """Host f64 copy of the problem arrays."""

    points: List[np.ndarray]          # per node [ni, 2]
    normals: List[np.ndarray]         # per node [ni, 2]
    planar_idx: List[np.ndarray]      # per node feature indices
    edge_idx: List[np.ndarray]
    odom_i: np.ndarray
    odom_j: np.ndarray
    odom_trans: np.ndarray
    odom_rot: np.ndarray

    @classmethod
    def from_device_problem(cls, problem) -> "CpuProblem":
        """Host copy of a port ``SLAMProblem``, whose tensors may lie on the
        card: each is copied to the host explicitly (``np.asarray`` on a
        CUDA tensor raises)."""
        def host(t, dtype=None):
            a = t.detach().cpu().numpy()
            return a if dtype is None else a.astype(dtype)

        pts_all = host(problem.points, np.float64)
        msk = host(problem.points_mask)
        nrm_all = host(problem.normals, np.float64)
        pidx, pmask = host(problem.planar_idx), host(problem.planar_mask)
        eidx, emask = host(problem.edge_idx), host(problem.edge_mask)
        n = pts_all.shape[0]
        return cls(
            points=[pts_all[i][msk[i]] for i in range(n)],
            normals=[nrm_all[i][msk[i]] for i in range(n)],
            planar_idx=[pidx[i][pmask[i]] for i in range(n)],
            edge_idx=[eidx[i][emask[i]] for i in range(n)],
            odom_i=host(problem.odom_i, np.int64),
            odom_j=host(problem.odom_j, np.int64),
            odom_trans=host(problem.odom_trans, np.float64),
            odom_rot=host(problem.odom_rot, np.float64),
        )


def _associate_pair(prob: CpuProblem, x, s, t, feat_idx_s, feat_idx_t, tree,
                    outlier):
    """NN matching of node s's features against node t's (tree over t)."""
    ps = prob.points[s][feat_idx_s]
    if len(ps) == 0 or tree is None:
        return None
    Rs, Rt = _rot(x[s, 2]), _rot(x[t, 2])
    proj = (ps @ Rs.T + x[s, :2] - x[t, :2]) @ Rt
    dist, nn = tree.query(proj)
    keep = dist < outlier
    if not np.any(keep):
        return None
    tgt_feature_positions = feat_idx_t[nn[keep]]
    return dict(
        s=s, t=t,
        src_pts=ps[keep],
        tgt_pts=prob.points[t][tgt_feature_positions],
        src_nrm=prob.normals[s][feat_idx_s[keep]],
        tgt_nrm=prob.normals[t][tgt_feature_positions],
    )


def associate(prob: CpuProblem, x, window, outlier) -> Tuple[list, list]:
    """All-pairs (i, j in [i-w, i)) planar + edge matches at solution x."""
    n = len(prob.points)
    planar_trees = {}
    edge_trees = {}
    for t in range(n):
        pi = prob.planar_idx[t]
        planar_trees[t] = cKDTree(prob.points[t][pi]) if len(pi) else None
        ei = prob.edge_idx[t]
        edge_trees[t] = cKDTree(prob.points[t][ei]) if len(ei) else None
    planar, edge = [], []
    for i in range(n):
        for j in range(max(i - window, 0), i):
            c = _associate_pair(prob, x, i, j, prob.planar_idx[i],
                                prob.planar_idx[j], planar_trees[j], outlier)
            if c:
                planar.append(c)
            c = _associate_pair(prob, x, i, j, prob.edge_idx[i],
                                prob.edge_idx[j], edge_trees[j], outlier)
            if c:
                edge.append(c)
    return planar, edge


def _corr_residual_jac(x, c, kind):
    """Residuals + per-dof Jacobian blocks for one correspondence set."""
    s, t = c["s"], c["t"]
    p, q = c["src_pts"], c["tgt_pts"]
    Rs, Rt = _rot(x[s, 2]), _rot(x[t, 2])
    dRs, dRt = _drot(x[s, 2]), _drot(x[t, 2])
    v = p @ Rs.T + x[s, :2] - x[t, :2]          # world - t_t
    p_t = v @ Rt                                 # A v with A = Rt^T
    # d(p_t)/d: ts -> Rt^T ; theta_s -> Rt^T dRs p ; tt -> -Rt^T ;
    # theta_t -> dRt^T v
    dpt_dts = Rt.T                               # [2, 2]
    dpt_dths = (p @ dRs.T) @ Rt                  # [m, 2]
    dpt_dtt = -Rt.T
    dpt_dtht = v @ dRt                           # [m, 2]  (= dRt^T v)
    if kind == "point":
        # r = q - p_t  => J = -d(p_t)/d.
        r = q - p_t                              # [m, 2]
        m = len(p)
        Js = np.zeros((m, 2, 3))
        Js[:, :, 0] = -np.broadcast_to(dpt_dts[:, 0], (m, 2))
        Js[:, :, 1] = -np.broadcast_to(dpt_dts[:, 1], (m, 2))
        Js[:, :, 2] = -dpt_dths
        Jt = np.zeros((m, 2, 3))
        Jt[:, :, 0] = -np.broadcast_to(dpt_dtt[:, 0], (m, 2))
        Jt[:, :, 1] = -np.broadcast_to(dpt_dtt[:, 1], (m, 2))
        Jt[:, :, 2] = -dpt_dtht
        return r.reshape(-1), Js.reshape(-1, 3), Jt.reshape(-1, 3)
    # Normal residuals: r1 = n_t . (p_t - q); r2 = n_s . (q - p_t).
    nt, ns = c["tgt_nrm"], c["src_nrm"]
    diff = p_t - q
    r1 = np.sum(nt * diff, axis=-1)
    r2 = np.sum(ns * (-diff), axis=-1)
    # d r1 / d dof = nt . d(p_t)/d dof ; d r2 = -ns . d(p_t)/d dof
    Js1 = np.stack([nt @ dpt_dts[:, 0], nt @ dpt_dts[:, 1],
                    np.sum(nt * dpt_dths, axis=-1)], axis=-1)
    Jt1 = np.stack([nt @ dpt_dtt[:, 0], nt @ dpt_dtt[:, 1],
                    np.sum(nt * dpt_dtht, axis=-1)], axis=-1)
    Js2 = -np.stack([ns @ dpt_dts[:, 0], ns @ dpt_dts[:, 1],
                     np.sum(ns * dpt_dths, axis=-1)], axis=-1)
    Jt2 = -np.stack([ns @ dpt_dtt[:, 0], ns @ dpt_dtt[:, 1],
                     np.sum(ns * dpt_dtht, axis=-1)], axis=-1)
    r = np.stack([r1, r2], axis=-1).reshape(-1)
    Js = np.stack([Js1, Js2], axis=1).reshape(-1, 3)
    Jt = np.stack([Jt1, Jt2], axis=1).reshape(-1, 3)
    return r, Js, Jt


def _segment_distance(w, a, b):
    """Vectorized point-to-segment distance (slam_util.h:91-110).

    w: [..., 2] points; a, b: [2] endpoints.  Projection clamped to the
    segment, matching the reference's DistanceToLineSegment.
    """
    u = b - a
    denom = float(u @ u)
    if denom == 0.0:
        return np.linalg.norm(w - a, axis=-1)
    t = np.clip(((w - a) @ u) / denom, 0.0, 1.0)
    closest = a[None, :] + t[..., None] * u[None, :]
    return np.linalg.norm(w - closest, axis=-1)


@dataclasses.dataclass
class CpuHitl:
    """One flattened HITL row set (reference HitlLCConstraint rows).

    dof layout matches the device engine (factors.py): node dofs are
    0..3n-1, line-pose dofs start at 3n; ``line`` holds num_nodes +
    line_pose_index, i.e. a direct row index into the extended x.
    """

    node: np.ndarray                 # [R] node indices
    line: np.ndarray                 # [R] extended-x row of the line pose
    points: List[np.ndarray]         # per row [k, 2] node-frame points
    seg_start: np.ndarray            # [R, 2] line-a start (line-pose frame)
    seg_end: np.ndarray              # [R, 2]


def _hitl_residual_row(x, node, line, pts, s0, s1):
    """Residuals of one HITL row at extended solution x [(n+L), 3]."""
    pn, pl = x[node], x[line]
    Rn, Rl = _rot(pn[2]), _rot(pl[2])
    world = pts @ Rn.T + pn[:2]
    a = Rl @ s0 + pl[:2]
    b = Rl @ s1 + pl[:2]
    return _segment_distance(world, a, b)


def _hitl_residual_jac(x, node, line, pts, s0, s1, h=1e-7):
    """Residual + central-difference Jacobian wrt (node pose, line pose).

    Ceres autodiffs the same clamped-projection formula
    (slam_residuals.h:179-216); central differences at h=1e-7 in f64 agree
    to ~1e-8, far below LM's trust-region tolerances, and keep this twin
    dependency-free.
    """
    r = _hitl_residual_row(x, node, line, pts, s0, s1)
    m = len(r)
    Jn = np.zeros((m, 3))
    Jl = np.zeros((m, 3))
    for d in range(3):
        for J, row in ((Jn, node), (Jl, line)):
            xp = x.copy(); xp[row, d] += h
            xm = x.copy(); xm[row, d] -= h
            J[:, d] = (_hitl_residual_row(xp, node, line, pts, s0, s1) -
                       _hitl_residual_row(xm, node, line, pts, s0, s1)) / (2 * h)
    return r, Jn, Jl


def build_system(prob: CpuProblem, x, planar, edge, tw, rw,
                 hitl: CpuHitl = None, n_dof_rows: int = None):
    """Global sparse Jacobian + residual vector (rows: residuals).

    x is [(n + L), 3] when hitl is given (L free line poses appended);
    n_dof_rows overrides the dof-column count (defaults to len(x))."""
    n = len(prob.points)
    n_rows = n_dof_rows if n_dof_rows is not None else len(x)
    rows_i, cols_i, vals = [], [], []
    res = []
    row0 = 0

    def add_block(r, Js, Jt, s, t):
        nonlocal row0
        m = len(r)
        res.append(r)
        rr = row0 + np.arange(m)
        for J, node in ((Js, s), (Jt, t)):
            for d in range(3):
                rows_i.append(rr)
                cols_i.append(np.full(m, 3 * node + d))
                vals.append(J[:, d])
        row0 += m

    # Odometry factors (reference slam_residuals.h:17-61), vectorized over
    # the whole factor list (the densified HITL case has ~N*w of them).
    nk = len(prob.odom_i)
    if nk:
        oi, oj = prob.odom_i, prob.odom_j
        et = x[oi, :2] + prob.odom_trans - x[oj, :2]
        dr = x[oi, 2] + prob.odom_rot - x[oj, 2]
        er = np.arctan2(np.sin(dr), np.cos(dr))
        r3 = np.stack([tw * et[:, 0], tw * et[:, 1], rw * er], axis=1)
        res.append(r3.reshape(-1))
        rr = row0 + 3 * np.arange(nk)
        wvec = np.array([tw, tw, rw])
        for d in range(3):
            rows_i.append(rr + d)
            cols_i.append(3 * oi + d)
            vals.append(np.full(nk, wvec[d]))
            rows_i.append(rr + d)
            cols_i.append(3 * oj + d)
            vals.append(np.full(nk, -wvec[d]))
        row0 += 3 * nk

    for c in planar:
        r, Js, Jt = _corr_residual_jac(x, c, "normal")
        add_block(r, Js, Jt, c["s"], c["t"])
    for c in edge:
        r, Js, Jt = _corr_residual_jac(x, c, "point")
        add_block(r, Js, Jt, c["s"], c["t"])

    if hitl is not None:
        for q in range(len(hitl.node)):
            r, Jn, Jl = _hitl_residual_jac(
                x, int(hitl.node[q]), int(hitl.line[q]), hitl.points[q],
                hitl.seg_start[q], hitl.seg_end[q])
            add_block(r, Jn, Jl, int(hitl.node[q]), int(hitl.line[q]))

    r_all = np.concatenate(res) if res else np.zeros(0)
    J = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows_i), np.concatenate(cols_i))),
        shape=(row0, 3 * n_rows)).tocsr()
    return J, r_all


def total_cost(prob: CpuProblem, x, planar, edge, tw, rw,
               hitl: CpuHitl = None) -> float:
    _, r = build_system(prob, x, planar, edge, tw, rw, hitl=hitl)
    return 0.5 * float(r @ r)


def lm_solve(prob: CpuProblem, x0, planar, edge, tw, rw,
             max_iterations=50, function_tolerance=1e-6,
             min_relative_decrease=1e-3, initial_radius=1e4,
             min_diagonal=1e-6, max_diagonal=1e32, hitl: CpuHitl = None,
             step_tolerance=0.0):
    """Same trust-region schedule as solve/lm.py, sparse f64."""
    x = x0.copy()
    n = len(x)
    radius, divisor = initial_radius, 2.0
    J, r = build_system(prob, x, planar, edge, tw, rw, hitl=hitl)
    cost = 0.5 * float(r @ r)
    fixed = np.zeros(3 * n, bool)
    fixed[:3] = True
    free = ~fixed
    it = 0
    while it < max_iterations and radius > 1e-32:
        it += 1
        H = (J.T @ J).tocsc()
        g = J.T @ r
        Hf = H[free][:, free]
        gf = g[free]
        d = np.clip(Hf.diagonal(), min_diagonal, max_diagonal)
        A = (Hf + sp.diags(d / radius)).tocsc()
        try:
            dxf = spla.spsolve(A, -gf)
        except Exception:
            dxf = np.full(free.sum(), np.nan)
        dx = np.zeros(3 * n)
        dx[free] = dxf
        if not np.all(np.isfinite(dx)):
            radius /= divisor
            divisor *= 2
            continue
        x_new = x + dx.reshape(n, 3)
        _, r_new = build_system(prob, x_new, planar, edge, tw, rw, hitl=hitl)
        new_cost = 0.5 * float(r_new @ r_new)
        model_decrease = -(gf @ dxf + 0.5 * dxf @ (Hf @ dxf))
        rho = (cost - new_cost) / max(model_decrease, 1e-300)
        if model_decrease > 0 and rho > min_relative_decrease:
            decrease = cost - new_cost
            x = x_new
            J, r = build_system(prob, x, planar, edge, tw, rw, hitl=hitl)
            cost = new_cost
            radius = min(radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3), 1e16)
            divisor = 2.0
            if abs(decrease) <= function_tolerance * (cost + decrease):
                break
            # accuracy_change_stop_threshold twin (lm.LMParams
            # .step_tolerance): mean |dx| per accepted step.
            if step_tolerance > 0 and np.mean(np.abs(dx)) <= step_tolerance:
                break
        else:
            radius /= divisor
            divisor *= 2
    return x, cost, it


@dataclasses.dataclass
class CpuSolveStats:
    windows: list = dataclasses.field(default_factory=list)
    total_wall_s: float = 0.0
    final_cost: float = float("nan")
    # The free line poses [L, 3] a HITL solve ends with (hitl_callback).
    line_poses: np.ndarray = None


def solve_slam(prob: CpuProblem, x0, cfg,
               hitl: CpuHitl = None) -> Tuple[np.ndarray, CpuSolveStats]:
    """Growing-window sweep, mirroring solve/solver.py / solver.cc:335-356."""
    x = np.asarray(x0, np.float64).copy()
    stats = CpuSolveStats()
    tw = float(cfg.translation_weight)
    rw = float(cfg.rotation_weight)
    outlier = float(cfg.outlier_threshold)
    t_start = time.perf_counter()
    for w in range(cfg.get_int("lidar_constraint_amount_min"),
                   cfg.get_int("lidar_constraint_amount_max") + 1):
        t0 = time.perf_counter()
        planar, edge = associate(prob, x, w, outlier)
        x, cost, iters = lm_solve(
            prob, x, planar, edge, tw, rw, hitl=hitl,
            step_tolerance=float(
                cfg.get("accuracy_change_stop_threshold", 0.0)))
        stats.windows.append(dict(window=w, cost=cost, iterations=iters,
                                  wall_s=time.perf_counter() - t0))
    stats.total_wall_s = time.perf_counter() - t_start
    stats.final_cost = stats.windows[-1]["cost"]
    return x, stats


# ---------------------------------------------------------------------------
# HITL curation twin (reference HitlCallback, solver.cc:534-559): the CPU
# baseline of the port's hitl_callback.
# ---------------------------------------------------------------------------

def select_hitl(prob: CpuProblem, x, line_a, line_b, width, threshold):
    """GetRelevantPosesForHITL twin (solver.cc:479-513): per node, points
    within ``width`` of segment A (else-if B); pose joins a line's set when
    >= threshold of its points qualify (A wins ties, solver.cc:503-510)."""
    a0, a1 = np.asarray(line_a[0]), np.asarray(line_a[1])
    b0, b1 = np.asarray(line_b[0]), np.asarray(line_b[1])
    a_rows, b_rows = [], []
    for node in range(len(prob.points)):
        R = _rot(x[node, 2])
        world = prob.points[node] @ R.T + x[node, :2]
        on_a = _segment_distance(world, a0, a1) <= width
        on_b = ~on_a & (_segment_distance(world, b0, b1) <= width)
        if on_a.sum() >= threshold:
            a_rows.append((node, prob.points[node][on_a]))
        elif on_b.sum() >= threshold:
            b_rows.append((node, prob.points[node][on_b]))
    return a_rows, b_rows


def densified_odom(x, max_window):
    """GetSolvedOdomFactors twin (solver.cc:406-427): every pair within
    max_window carries the current solution's raw relative pose."""
    n = len(x)
    jj = np.repeat(np.arange(1, n), np.minimum(np.arange(1, n), max_window))
    offsets = np.concatenate(
        [np.arange(min(j, max_window), 0, -1) for j in range(1, n)])
    ii = jj - offsets
    return ii, jj, x[jj, :2] - x[ii, :2], x[jj, 2] - x[ii, 2]


def hitl_rows(prob: CpuProblem, x, cfg, line_a, line_b) -> CpuHitl:
    """The HITL rows of one line pair selected at solution x: every selected
    pose against line A's segment under one free line pose, extended-x row
    n (line_a used for BOTH pose sets, solver.cc:521,528)."""
    n = len(prob.points)
    a_rows, b_rows = select_hitl(
        prob, x, line_a, line_b, float(cfg.hitl_line_width),
        cfg.get_int("hitl_pose_point_threshold"))
    rows = a_rows + b_rows
    return CpuHitl(
        node=np.array([r[0] for r in rows], np.int64),
        line=np.full(len(rows), n, np.int64),   # one free line pose, row n
        points=[r[1] for r in rows],
        seg_start=np.tile(np.asarray(line_a[0], np.float64), (len(rows), 1)),
        seg_end=np.tile(np.asarray(line_a[1], np.float64), (len(rows), 1)))


def hitl_callback(prob: CpuProblem, x, cfg, line_a, line_b):
    """HitlCallback twin: densified odometry, HITL residuals against line
    A's segment under a free line pose (``hitl_rows``), solve, restore
    original odometry, solve again.  Applies the same KNOWN FIX as
    solve/hitl.py: the restored factors are the real ingest-time ones, not
    the reference's never-populated list.  Returns the node poses and the
    second solve's stats, whose ``line_poses`` hold the line pose."""
    n = len(prob.points)
    hitl = hitl_rows(prob, x, cfg, line_a, line_b)
    x_ext = np.concatenate([x, np.zeros((1, 3))], axis=0)
    orig = (prob.odom_i, prob.odom_j, prob.odom_trans, prob.odom_rot)
    prob.odom_i, prob.odom_j, prob.odom_trans, prob.odom_rot = \
        densified_odom(x, cfg.get_int("lidar_constraint_amount_max"))
    try:
        x_ext, _ = solve_slam(prob, x_ext, cfg, hitl=hitl)
        prob.odom_i, prob.odom_j, prob.odom_trans, prob.odom_rot = orig
        x_ext, stats2 = solve_slam(prob, x_ext, cfg, hitl=hitl)
    finally:
        prob.odom_i, prob.odom_j, prob.odom_trans, prob.odom_rot = orig
    stats2.line_poses = x_ext[n:].copy()
    return x_ext[:n], stats2
