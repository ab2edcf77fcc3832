"""The plain reference of the loop-closure candidates and the chi-square
gate (numpy/scipy, float64).

- Candidates: walking the poses in order, a pose is a candidate when it
  lies at least 5 m from the previous candidate and its whole scan's
  scatter score lambda_min / lambda_max is at least 0.70.
  Of those, a candidate stays when its scan, merged with its 2
  predecessors moved into its frame through the solution, is well
  conditioned: from the point-to-plane information of the merged points
  (rows [n_x, n_y, n . d(R p)/d theta]), the translation block's
  eigenvalue ratio is under 9.5 and 1 / sqrt(lambda_min / points) under
  2.5.
- Pairs: two candidates within lc_base_max_range + lc_max_range_scaling *
  |s - t| metres of each other.
- Gate: the Gauss-Newton Hessian of the max-window problem at the
  solution, gauged at pose max(min(s, t) - 1, 0) (its rows and columns
  zeroed, a unit diagonal there, 1e-8 added everywhere); the (s, t) cross
  block of its inverse, top-left 2 x 2, is C, and the pair passes when
  (t - s)^T C^-1 (t - s) < 5000 over the solved translations.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from portbench.reference import referee

CHI_SQUARE_THRESHOLD = 5000.0


def candidates(scores, x, follow, min_distance=5.0, threshold=0.70,
               tie=1e-5):
    """The candidate chain.  ``follow`` (a set of poses) decides the poses
    whose score lies within ``tie`` of the threshold, where a float32 sum
    may fall on either side."""
    out = []
    for i in range(len(x)):
        if out and np.linalg.norm(x[i, :2] - x[out[-1], :2]) < min_distance:
            continue
        near = abs(scores[i] - threshold) < tie
        if (i in follow) if near else scores[i] >= threshold:
            out.append(i)
    return out


def uncertainty(points, mask, normals, x, nodes, prev):
    """(condition, scale) of each node's scan merged with its ``prev``
    predecessors (none before pose 0), in the node's frame."""
    conds, scales = [], []
    for i in nodes:
        rows = []
        for j in range(max(i - prev, 0), i + 1):
            dth = x[j, 2] - x[i, 2]
            c, s = np.cos(dth), np.sin(dth)
            R = np.array([[c, -s], [s, c]])
            ci, si = np.cos(x[i, 2]), np.sin(x[i, 2])
            dt = np.array([[ci, si], [-si, ci]]) @ (x[j, :2] - x[i, :2])
            p = points[j][mask[j]].astype(np.float64) @ R.T + dt
            n = normals[j][mask[j]] @ R.T
            rows.append(np.stack([n[:, 0], n[:, 1],
                                  -p[:, 1] * n[:, 0] + p[:, 0] * n[:, 1]], -1))
        J = np.concatenate(rows)
        H = J.T @ J
        tr = H[0, 0] + H[1, 1]
        det = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
        disc = np.sqrt(max(tr * tr - 4 * det, 0.0))
        lam_min = max(0.5 * (tr - disc), 1e-12)
        conds.append(0.5 * (tr + disc) / lam_min)
        scales.append(1.0 / np.sqrt(lam_min / max(len(J), 1)))
    return np.array(conds), np.array(scales)


def keep_certain(chain, conds, scales, cond_max, scale_max, follow,
                 tie=1e-4):
    """The candidates of ``chain`` whose merged scans are well conditioned;
    ``follow`` decides those within a relative ``tie`` of a threshold."""
    out = []
    for node, c, s in zip(chain, conds, scales):
        near = (abs(c / cond_max - 1) < tie) or (abs(s / scale_max - 1) < tie)
        if (node in follow) if near else (c < cond_max and s < scale_max):
            out.append(node)
    return out


def range_pairs(cands, x, base, scaling):
    """Candidate pairs (min, max) within the range prefilter."""
    cands = np.asarray(cands, np.int64)
    pos = x[cands, :2]
    pairs = set()
    for k, s in enumerate(cands):
        d = np.linalg.norm(pos - pos[k], axis=1)
        ok = (d <= base + scaling * np.abs(cands - s)) & (cands != s)
        pairs.update((min(int(s), int(t)), max(int(s), int(t)))
                     for t in cands[ok])
    return sorted(pairs)


def chi_square(prob, x, cfg: referee.Settings, factors, pairs):
    """{pair: score} for pairs (s, t) at solution x."""
    planar, edge = referee.associate(prob, x, cfg.w_max, cfg.outlier)
    H, _ = referee.normal_equations(
        referee.evaluate(prob, x, planar, edge, factors), len(x))
    H = H.tocsr()
    n_dof = H.shape[0]
    groups = {}
    for s, t in pairs:
        groups.setdefault(max(min(s, t) - 1, 0), []).append((s, t))
    out = {}
    for fixed_pose, group in groups.items():
        fixed = (np.arange(n_dof) // 3) == fixed_pose
        keep = sp.diags((~fixed).astype(float))
        Hg = (keep @ H @ keep + sp.diags(fixed + 1e-8)).tocsc()
        lu = spla.splu(Hg)
        cols = np.zeros((n_dof, 3 * len(group)))
        for k, (_, t) in enumerate(group):
            cols[3 * t:3 * t + 3, 3 * k:3 * k + 3] = np.eye(3)
        X = lu.solve(cols)
        for k, (s, t) in enumerate(group):
            cov = X[3 * s:3 * s + 2, 3 * k:3 * k + 2]
            delta = x[t, :2] - x[s, :2]
            try:
                score = float(delta @ np.linalg.inv(cov) @ delta)
            except np.linalg.LinAlgError:
                score = float("inf")
            out[(s, t)] = score if np.isfinite(score) else float("inf")
    return out
