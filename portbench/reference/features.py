"""Normals and LOAM-style features of the benchmark's scans (numpy).

- PCA normals: for each point, the neighbours within the smallest radius of
  the growth schedule 0.15, 0.25, 0.35, 0.45 m that holds at least two
  points (itself included); the normal is the minor eigenvector of their
  scatter, turned into the upper half-plane.  Computed in float64 on the
  neighbour sets that the float32 distance test gives.
- Smoothness: lambda_min / lambda_max of the scatter of the points within
  +-10 indices and 2 m (at least 10 of them).  Straight walls give scores
  that are rounding noise around 0, and the greedy selection sorts them,
  so this score is computed in float32 in one fixed summation order:
  sequential sums over index windows of 32, the window sums added in
  turn, and the mean's sums split by index mod 4.  A different order
  selects different features.
- Greedy selection: planar = lowest scores at or below 0.008, edge =
  highest at or above it, at least 2 m apart, at most 20 and 10 a scan,
  over the first 128 candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

F32 = np.float32
THRESHOLD = F32(0.008)
DISTANCE = 2.0
NEIGHBORS_PER_SIDE = 10
MIN_NEIGHBORS = 10
MAX_PLANAR, MAX_EDGE = 20, 10
GREEDY_CANDIDATES = 128
RADII = (F32(0.15) + F32(0.1) * np.arange(4, dtype=F32))   # float32 schedule


class Features(NamedTuple):
    normals: np.ndarray       # [N, P, 2] float64
    planar_idx: np.ndarray    # [N, 20] int64
    planar_mask: np.ndarray   # [N, 20] bool
    edge_idx: np.ndarray      # [N, 10] int64
    edge_mask: np.ndarray     # [N, 10] bool


def _fma_sqrt_disc(sxx, sxy, syy):
    """float32 sqrt((sxx - syy)^2 + 4 sxy^2) with the square of the
    difference fused into the add and a correctly rounded root."""
    d = sxx - syy
    c = (F32(4.0) * sxy) * sxy
    v = (d.astype(np.float64) * d.astype(np.float64)
         + c.astype(np.float64)).astype(F32)
    return np.sqrt(np.maximum(v, F32(0.0)).astype(np.float64)).astype(F32)


def smoothness(points, mask):
    """float32 scores [N, P] and validity [N, P]."""
    n, p, _ = points.shape
    offs = np.arange(-NEIGHBORS_PER_SIDE, NEIGHBORS_PER_SIDE + 1)
    rows = np.arange(p)
    idx = rows[:, None] + offs[None, :]                    # [P, K]
    inside = (idx >= 0) & (idx < p)
    idx_c = np.clip(idx, 0, p - 1)
    q = points[:, idx_c]                                   # [N, P, K, 2]
    qm = mask[:, idx_c] & inside[None] & mask[:, :, None]
    diff = points[:, :, None, :] - q
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    centre = offs == 0
    nbr = qm & (d2 <= F32(DISTANCE ** 2)) & ~centre[None, None, :]
    valid = (nbr.sum(-1) >= MIN_NEIGHBORS) & mask
    w = nbr | (centre[None, None, :] & mask[:, :, None])
    cnt = np.maximum(w.sum(-1), 1).astype(F32)
    # Mean: four partial sums by index mod 4, each in index order.
    acc = np.zeros((n, p, 4, 2), F32)
    for k in range(idx.shape[1]):
        r = idx_c[:, k] % 4
        term = np.where(w[:, :, k, None], q[:, :, k], F32(0.0))
        acc[:, rows, r] = acc[:, rows, r] + term
    mean = ((acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])) \
        / cnt[..., None]
    cx = q[..., 0] - mean[:, :, None, 0]
    cy = q[..., 1] - mean[:, :, None, 1]
    # Sums over windows of 32 indices: the neighbourhood spans at most two.
    first = np.maximum(rows - NEIGHBORS_PER_SIDE, 0) // 32
    in_b = (idx_c // 32) > first[:, None]                  # [P, K]
    sums = []
    for term in (cx * cx, cx * cy, cy * cy):
        term = np.where(w, term, F32(0.0))
        wa = np.zeros((n, p), F32)
        wb = np.zeros((n, p), F32)
        for k in range(idx.shape[1]):
            t = term[:, :, k]
            wa = wa + np.where(in_b[None, :, k], F32(0.0), t)
            wb = wb + np.where(in_b[None, :, k], t, F32(0.0))
        sums.append(wa + wb)
    sxx, sxy, syy = sums
    tr = sxx + syy
    disc = _fma_sqrt_disc(sxx, sxy, syy)
    lam_max = F32(0.5) * (tr + disc)
    lam_min = F32(0.5) * (tr - disc)
    score = lam_min / np.maximum(lam_max, F32(1e-20))
    return np.clip(score, F32(0.0), F32(1.0)), valid


def _greedy(points, order, ok, max_count):
    n = points.shape[0]
    rows = np.arange(n)
    sel_pts = np.full((n, max_count, 2), F32(1e9), F32)
    sel_idx = np.zeros((n, max_count), np.int64)
    count = np.zeros(n, np.int64)
    for step in range(min(order.shape[1], GREEDY_CANDIDATES)):
        cand = order[:, step]
        pt = points[rows, cand]
        d = sel_pts - pt[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        accept = (ok[rows, cand] & (d2.min(-1) >= F32(DISTANCE ** 2))
                  & (count < max_count))
        slot = np.where(accept, count, max_count - 1)
        sel_pts[rows[accept], slot[accept]] = pt[accept]
        sel_idx[rows[accept], slot[accept]] = cand[accept]
        count += accept
    sel_mask = np.arange(max_count)[None, :] < count[:, None]
    return np.where(sel_mask, sel_idx, 0), sel_mask


def select_features(points, mask):
    """(planar_idx, planar_mask, edge_idx, edge_mask) of every scan."""
    score, valid = smoothness(points, mask)
    inf = F32(np.inf)
    asc = np.argsort(np.where(valid, score, inf), axis=1, kind="stable")
    planar = _greedy(points, asc, valid & (score <= THRESHOLD), MAX_PLANAR)
    desc = np.argsort(np.where(valid, -score, inf), axis=1, kind="stable")
    edge = _greedy(points, desc, valid & (score >= THRESHOLD), MAX_EDGE)
    return planar + edge


def _scan_normals(pts32):
    """float64 PCA normals [M, 2] of one unpadded float32 cloud [M, 2]."""
    m = len(pts32)
    pairs = cKDTree(pts32.astype(np.float64)).query_pairs(
        float(RADII[-1]) + 1e-4, output_type="ndarray")
    i = np.concatenate([pairs[:, 0], pairs[:, 1]])
    j = np.concatenate([pairs[:, 1], pairs[:, 0]])
    d = pts32[i] - pts32[j]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]              # float32 test
    r2 = RADII * RADII
    # Smallest radius whose ball holds another point; else the largest.
    counts = np.stack([np.bincount(i, d2 <= r, minlength=m) for r in r2])
    enough = counts >= 1
    pick = np.where(enough.any(0), np.argmax(enough, 0), len(r2) - 1)
    keep = d2 <= r2[pick[i]]
    i, j = i[keep], j[keep]
    p = pts32.astype(np.float64)
    n = 1.0 + np.bincount(i, minlength=m)
    sx = p[:, 0] + np.bincount(i, p[j, 0], minlength=m)
    sy = p[:, 1] + np.bincount(i, p[j, 1], minlength=m)
    mx, my = sx / n, sy / n
    cx = np.concatenate([p[:, 0] - mx, p[j, 0] - mx[i]])
    cy = np.concatenate([p[:, 1] - my, p[j, 1] - my[i]])
    owner = np.concatenate([np.arange(m), i])
    sxx = np.bincount(owner, cx * cx, minlength=m)
    sxy = np.bincount(owner, cx * cy, minlength=m)
    syy = np.bincount(owner, cy * cy, minlength=m)
    disc = np.sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy)
    lam_min = 0.5 * (sxx + syy - disc)
    v1 = np.stack([sxy, lam_min - sxx], -1)
    v2 = np.stack([lam_min - syy, sxy], -1)
    use_v1 = (v1 * v1).sum(-1) >= (v2 * v2).sum(-1)
    v = np.where(use_v1[:, None], v1, v2)
    v = v / np.sqrt(np.maximum((v * v).sum(-1), 1e-30))[:, None]
    v = np.where((disc < 1e-12)[:, None], np.array([1.0, 0.0]), v)
    flip = (v[:, 1] < 0) | ((v[:, 1] == 0) & (v[:, 0] < 0))
    return np.where(flip[:, None], -v, v)


def normals(points, mask):
    out = np.zeros(points.shape, np.float64)
    for k in range(points.shape[0]):
        out[k, mask[k]] = _scan_normals(points[k][mask[k]])
    return out


def compute(points, mask, chunk: int = 64) -> Features:
    """Normals and features of the scans points [N, P, 2] float32."""
    parts = [select_features(points[c:c + chunk], mask[c:c + chunk])
             for c in range(0, points.shape[0], chunk)]
    cols = [np.concatenate(col) for col in zip(*parts)]
    return Features(normals(points, mask), *cols)


def scatter_score(points, mask):
    """lambda_min / lambda_max of each scan's whole cloud (float64); 0 for
    fewer than two points."""
    out = np.zeros(points.shape[0])
    for k in range(points.shape[0]):
        p = points[k][mask[k]].astype(np.float64)
        if len(p) < 2:
            continue
        c = p - p.mean(0)
        sxx, sxy, syy = (c[:, 0] ** 2).sum(), (c[:, 0] * c[:, 1]).sum(), \
            (c[:, 1] ** 2).sum()
        disc = np.sqrt((sxx - syy) ** 2 + 4 * sxy * sxy)
        lmax, lmin = 0.5 * (sxx + syy + disc), 0.5 * (sxx + syy - disc)
        out[k] = np.clip(lmin / max(lmax, 1e-20), 0.0, 1.0)
    return out
