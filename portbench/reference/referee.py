"""The plain reference of the solve and the loop-closure factors: float64
numpy/scipy, vectorized over pose pairs.

It computes what the port's float64 CPU referee computes (nearest-feature
association, point and normal residuals with analytic Jacobians, odometry
residuals, Ceres' Levenberg-Marquardt schedule on sparse normal equations
and the growing-window sweep), from the benchmark's own scans and
features.  It imports nothing of the program.

The problem is held padded: each node's planar (edge) features are rows of
[N, PL, 2] ([N, ED, 2]) arrays with masks, and a window's correspondences
are, for every pose pair (i, j) with 1 <= i - j <= w, the nearest target
feature of each source feature within the outlier distance.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


class Problem(NamedTuple):
    points: np.ndarray       # [N, P, 2] float64 (node frame)
    mask: np.ndarray         # [N, P] bool
    pl_pts: np.ndarray       # [N, PL, 2]
    pl_nrm: np.ndarray
    pl_mask: np.ndarray      # [N, PL]
    ed_pts: np.ndarray       # [N, ED, 2]
    ed_mask: np.ndarray


class Factors(NamedTuple):
    """Relative-pose factors: odometry and loop closures, with weights."""

    i: np.ndarray
    j: np.ndarray
    trans: np.ndarray        # [F, 2] world-frame delta i -> j
    rot: np.ndarray          # [F]
    wt: np.ndarray           # [F]
    wr: np.ndarray           # [F]


def make_problem(points32, mask, feats) -> Problem:
    """From float32 scans and reference.features.Features."""
    pts = points32.astype(np.float64)
    take = lambda a, idx: np.take_along_axis(a, idx[..., None], axis=1)
    return Problem(points=pts, mask=mask,
                   pl_pts=take(pts, feats.planar_idx),
                   pl_nrm=take(feats.normals, feats.planar_idx),
                   pl_mask=feats.planar_mask,
                   ed_pts=take(pts, feats.edge_idx),
                   ed_mask=feats.edge_mask)


def odometry(i, j, trans, rot, tw, rw) -> Factors:
    n = len(i)
    return Factors(np.asarray(i, np.int64), np.asarray(j, np.int64),
                   np.asarray(trans, np.float64).reshape(n, 2),
                   np.asarray(rot, np.float64), np.full(n, float(tw)),
                   np.full(n, float(rw)))


def join(a: Factors, b: Factors) -> Factors:
    return Factors(*[np.concatenate([u, v]) for u, v in zip(a, b)])


def closure_factor(x, s, t, transform, wt, wr):
    """A scan match (cloud s into cloud t's frame) as a factor between
    min(s, t) and max(s, t): s placed where the match puts it relative to
    t's solved pose."""
    c, sn = np.cos(x[t, 2]), np.sin(x[t, 2])
    implied_s = np.array([x[t, 0] + c * transform[0] - sn * transform[1],
                          x[t, 1] + sn * transform[0] + c * transform[1],
                          x[t, 2] + transform[2]])
    implied = {s: implied_s, t: x[t]}
    i, j = min(s, t), max(s, t)
    return (i, j, implied[j][:2] - implied[i][:2],
            float(implied[j][2] - implied[i][2]), wt, wr)


def closures(x, matches, wt, wr) -> Factors:
    """Factors of accepted matches [(s, t, [tx, ty, theta]), ...]."""
    rows = [closure_factor(x, s, t, np.asarray(tf, np.float64), wt, wr)
            for s, t, tf in matches]
    if not rows:
        return odometry([], [], np.zeros((0, 2)), [], wt, wr)
    return Factors(np.array([r[0] for r in rows], np.int64),
                   np.array([r[1] for r in rows], np.int64),
                   np.array([r[2] for r in rows]),
                   np.array([r[3] for r in rows]),
                   np.array([r[4] for r in rows], np.float64),
                   np.array([r[5] for r in rows], np.float64))


# -- association ---------------------------------------------------------

class Matches(NamedTuple):
    """One feature kind's correspondences over the window's pose pairs."""

    s: np.ndarray            # [Q] source node
    t: np.ndarray            # [Q] target node
    src: np.ndarray          # [Q, F, 2] source feature (node s frame)
    tgt: np.ndarray          # [Q, F, 2] matched target feature (node t)
    src_nrm: Optional[np.ndarray]
    tgt_nrm: Optional[np.ndarray]
    keep: np.ndarray         # [Q, F]


def pose_pairs(n, window):
    """(i, j) with i - window <= j < i, i ascending, then j ascending."""
    i = np.repeat(np.arange(n), np.minimum(np.arange(n), window))
    j = np.concatenate([np.arange(max(k - window, 0), k) for k in range(n)]
                       or [np.zeros(0, np.int64)]).astype(np.int64)
    return i, j


def _to_target(x, s, t, p):
    """Points p [Q, F, 2] of node s in node t's frame: (v, p_t) with v the
    world point minus t's translation."""
    cs, ss = np.cos(x[s, 2])[:, None], np.sin(x[s, 2])[:, None]
    ct, st = np.cos(x[t, 2])[:, None], np.sin(x[t, 2])[:, None]
    vx = cs * p[..., 0] - ss * p[..., 1] + (x[s, 0] - x[t, 0])[:, None]
    vy = ss * p[..., 0] + cs * p[..., 1] + (x[s, 1] - x[t, 1])[:, None]
    return (vx, vy), (ct * vx + st * vy, -st * vx + ct * vy)


def _match(x, s, t, pts, mask, nrm, outlier):
    src = pts[s]
    _, (lx, ly) = _to_target(x, s, t, src)
    tgt = pts[t]
    d2 = ((lx[:, :, None] - tgt[:, None, :, 0]) ** 2
          + (ly[:, :, None] - tgt[:, None, :, 1]) ** 2)
    d2 = np.where(mask[t][:, None, :], d2, np.inf)
    nn = np.argmin(d2, axis=-1)
    dmin = np.take_along_axis(d2, nn[..., None], -1)[..., 0]
    keep = mask[s] & (np.sqrt(dmin) < outlier)
    gat = lambda a: np.take_along_axis(a, nn[..., None], 1)
    return Matches(s, t, src, gat(tgt), None if nrm is None else nrm[s],
                   None if nrm is None else gat(nrm[t]), keep)


def associate(prob: Problem, x, window, outlier):
    """(planar, edge) Matches at solution x."""
    s, t = pose_pairs(len(prob.points), window)
    return (_match(x, s, t, prob.pl_pts, prob.pl_mask, prob.pl_nrm, outlier),
            _match(x, s, t, prob.ed_pts, prob.ed_mask, None, outlier))


# -- residuals and Jacobians -----------------------------------------------

def _match_rows(x, m: Matches, normal: bool, jac: bool):
    """Residuals [Q, F, k] (k = 2) and, with jac, d r / d (x_s, x_t)
    [Q, F, k, 6]; zero where a feature found no match."""
    s, t, p = m.s, m.t, m.src
    (vx, vy), (lx, ly) = _to_target(x, s, t, p)
    dx, dy = lx - m.tgt[..., 0], ly - m.tgt[..., 1]
    if normal:
        nt, ns = m.tgt_nrm, m.src_nrm
        r = np.stack([nt[..., 0] * dx + nt[..., 1] * dy,
                      -(ns[..., 0] * dx + ns[..., 1] * dy)], -1)
    else:
        r = np.stack([-dx, -dy], -1)
    r = np.where(m.keep[..., None], r, 0.0)
    if not jac:
        return r, None
    cs, ss = np.cos(x[s, 2])[:, None], np.sin(x[s, 2])[:, None]
    ct, st = np.cos(x[t, 2])[:, None], np.sin(x[t, 2])[:, None]
    # d p_t / d (ts, theta_s, tt, theta_t): columns of 2-vectors.
    dths_w = (-ss * p[..., 0] - cs * p[..., 1], cs * p[..., 0] - ss * p[..., 1])
    d = np.zeros(p.shape[:2] + (2, 6))
    one = np.ones(p.shape[:2])
    d[..., 0, 0], d[..., 1, 0] = ct * one, -st * one
    d[..., 0, 1], d[..., 1, 1] = st * one, ct * one
    d[..., 0, 2] = ct * dths_w[0] + st * dths_w[1]
    d[..., 1, 2] = -st * dths_w[0] + ct * dths_w[1]
    d[..., :, 3:5] = -d[..., :, 0:2]
    d[..., 0, 5] = -st * vx + ct * vy
    d[..., 1, 5] = -ct * vx - st * vy
    if normal:
        J = np.stack([np.einsum("qfk,qfkc->qfc", nt, d),
                      -np.einsum("qfk,qfkc->qfc", ns, d)], 2)
    else:
        J = -d
    return r, np.where(m.keep[..., None, None], J, 0.0)


def _factor_rows(x, f: Factors, jac: bool):
    et = x[f.i, :2] + f.trans - x[f.j, :2]
    dr = x[f.i, 2] + f.rot - x[f.j, 2]
    er = np.arctan2(np.sin(dr), np.cos(dr))
    w = np.stack([f.wt, f.wt, f.wr], -1)
    r = w * np.stack([et[:, 0], et[:, 1], er], -1)
    if not jac:
        return r, None
    J = np.zeros((len(f.i), 3, 6))
    for d in range(3):
        J[:, d, d] = w[:, d]
        J[:, d, 3 + d] = -w[:, d]
    return r, J


def evaluate(prob, x, planar, edge, factors, jac=True):
    """Residual blocks: per row group the two poses it couples, its
    Jacobian and residuals."""
    out = []
    for m, normal in ((planar, True), (edge, False)):
        r, J = _match_rows(x, m, normal, jac)
        q = len(m.s)
        out.append((np.stack([m.s, m.t], -1), None if J is None
                    else J.reshape(q, -1, 6), r.reshape(q, -1)))
    r, J = _factor_rows(x, factors, jac)
    out.append((np.stack([factors.i, factors.j], -1), J, r))
    return out


def cost_of(blocks):
    return 0.5 * float(sum(np.sum(r * r) for _, _, r in blocks))


def normal_equations(blocks, n_poses):
    """Sparse H = J^T J [3n, 3n] and g = J^T r from per-group 6 x 6 sums."""
    rows, cols, vals = [], [], []
    g = np.zeros(3 * n_poses)
    for nodes, J, r in blocks:
        Hq = np.einsum("qmi,qmj->qij", J, J)
        gq = np.einsum("qmi,qm->qi", J, r)
        dof = (3 * nodes[:, :, None] + np.arange(3)).reshape(-1, 6)
        rows.append(np.repeat(dof, 6, axis=1).reshape(-1))
        cols.append(np.tile(dof, (1, 6)).reshape(-1))
        vals.append(Hq.reshape(-1))
        np.add.at(g, dof.reshape(-1), gq.reshape(-1))
    H = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(3 * n_poses, 3 * n_poses)).tocsc()
    return H, g


# -- Levenberg-Marquardt ---------------------------------------------------

def lm_solve(prob, x0, planar, edge, factors, max_iterations=50,
             function_tolerance=1e-6, min_relative_decrease=1e-3,
             initial_radius=1e4, min_diagonal=1e-6, max_diagonal=1e32,
             step_tolerance=0.0):
    """Ceres' trust-region schedule with pose 0 held fixed.  Returns (x,
    cost, iterations)."""
    x = x0.copy()
    n = len(x)
    radius, divisor = initial_radius, 2.0
    blocks = evaluate(prob, x, planar, edge, factors)
    cost = cost_of(blocks)
    free = np.ones(3 * n, bool)
    free[:3] = False
    it = 0
    while it < max_iterations and radius > 1e-32:
        it += 1
        H, g = normal_equations(blocks, n)
        Hf = H[free][:, free]
        gf = g[free]
        d = np.clip(Hf.diagonal(), min_diagonal, max_diagonal)
        try:
            dxf = spla.spsolve((Hf + sp.diags(d / radius)).tocsc(), -gf)
        except (RuntimeError, ValueError):
            dxf = np.full(gf.shape, np.nan)
        dx = np.zeros(3 * n)
        dx[free] = dxf
        if not np.all(np.isfinite(dx)):
            radius /= divisor
            divisor *= 2
            continue
        x_new = x + dx.reshape(n, 3)
        new_cost = cost_of(evaluate(prob, x_new, planar, edge, factors,
                                    jac=False))
        model_decrease = -(gf @ dxf + 0.5 * dxf @ (Hf @ dxf))
        rho = (cost - new_cost) / max(model_decrease, 1e-300)
        if model_decrease > 0 and rho > min_relative_decrease:
            decrease = cost - new_cost
            x = x_new
            blocks = evaluate(prob, x, planar, edge, factors)
            cost = new_cost
            radius = min(radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3), 1e16)
            divisor = 2.0
            if abs(decrease) <= function_tolerance * (cost + decrease):
                break
            if step_tolerance > 0 and np.mean(np.abs(dx)) <= step_tolerance:
                break
        else:
            radius /= divisor
            divisor *= 2
    return x, cost, it


@dataclasses.dataclass
class Settings:
    """The configuration keys the reference reads."""

    w_min: int
    w_max: int
    outlier: float
    tw: float
    rw: float
    step_tolerance: float

    @classmethod
    def from_keys(cls, keys: dict) -> "Settings":
        return cls(int(keys["lidar_constraint_amount_min"]),
                   int(keys["lidar_constraint_amount_max"]),
                   float(keys["outlier_threshold"]),
                   float(keys["translation_weight"]),
                   float(keys["rotation_weight"]),
                   float(keys["accuracy_change_stop_threshold"]))


def sweep(prob, x0, cfg: Settings, factors, w_min=None):
    """The growing-window solve: windows w_min..w_max, each associating at
    the current solution and running LM.  Returns (x, [window costs])."""
    x = np.asarray(x0, np.float64).copy()
    costs = []
    for w in range(cfg.w_min if w_min is None else w_min, cfg.w_max + 1):
        planar, edge = associate(prob, x, w, cfg.outlier)
        x, c, _ = lm_solve(prob, x, planar, edge, factors,
                           step_tolerance=cfg.step_tolerance)
        costs.append(c)
    return x, costs


def cost_at(prob, x, cfg: Settings, factors):
    """The cost at x under its own max-window correspondences: the
    yardstick that compares two solutions."""
    planar, edge = associate(prob, x, cfg.w_max, cfg.outlier)
    return cost_of(evaluate(prob, x, planar, edge, factors, jac=False))
