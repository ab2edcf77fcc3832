"""Vector map extraction: fused cloud -> line segments -> CSV (port of
nautilus_tpu/io/vectorize.py; host numpy, segment for segment the same).

Replaces the reference's VectorMaps::ExtractLines native call
(src/optimization/solver.cc:581-624, third_party vector_maps) with a
host-side sequential-RANSAC extractor: repeatedly fit the strongest line
among remaining points, clip it to the inlier extent, split on gaps, and
remove consumed points.  Off the hot path (runs once per /vectorize_output
command), so plain numpy is the right tool.

Output contract matches the reference: CSV rows
``start_x,start_y,end_x,end_y`` (solver.cc:608-618).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np


def _fit_line(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Total-least-squares line fit -> (point_on_line, unit_direction)."""
    mean = pts.mean(axis=0)
    c = pts - mean
    cov = c.T @ c
    w, v = np.linalg.eigh(cov)
    return mean, v[:, np.argmax(w)]


def extract_lines(points: np.ndarray, inlier_threshold: float = 0.04,
                  min_inliers: int = 25, max_lines: int = 200,
                  gap_threshold: float = 0.5, ransac_iters: int = 60,
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Extract line segments from a 2D point cloud.

    Returns [(start [2], end [2]), ...].  Deterministic for a given seed.
    """
    rng = np.random.default_rng(seed)
    pts = np.asarray(points, np.float64)
    segments: List[Tuple[np.ndarray, np.ndarray]] = []
    remaining = pts
    for _ in range(max_lines):
        if len(remaining) < min_inliers:
            break
        best_count, best_inliers = 0, None
        n = len(remaining)
        for _ in range(ransac_iters):
            i, j = rng.integers(0, n, size=2)
            if i == j:
                continue
            a, b = remaining[i], remaining[j]
            d = b - a
            norm = np.linalg.norm(d)
            if norm < 1e-9:
                continue
            d = d / norm
            normal = np.array([-d[1], d[0]])
            dist = np.abs((remaining - a) @ normal)
            inliers = dist < inlier_threshold
            count = int(inliers.sum())
            if count > best_count:
                best_count, best_inliers = count, inliers
        if best_inliers is None or best_count < min_inliers:
            break
        sel = remaining[best_inliers]
        mean, direction = _fit_line(sel)
        # Refine inliers against the TLS fit.
        normal = np.array([-direction[1], direction[0]])
        dist = np.abs((remaining - mean) @ normal)
        inliers = dist < inlier_threshold
        sel = remaining[inliers]
        if len(sel) < min_inliers:
            remaining = remaining[~best_inliers]
            continue
        # Split on gaps along the line, emit one segment per dense run.
        t = (sel - mean) @ direction
        order = np.argsort(t)
        t_sorted = t[order]
        run_start = 0
        consumed = np.zeros(len(sel), bool)
        for k in range(1, len(t_sorted) + 1):
            if k == len(t_sorted) or t_sorted[k] - t_sorted[k - 1] > gap_threshold:
                run = order[run_start:k]
                if len(run) >= min_inliers:
                    lo, hi = t[run].min(), t[run].max()
                    segments.append((mean + lo * direction,
                                     mean + hi * direction))
                    consumed[run] = True
                run_start = k
        if not consumed.any():
            remaining = remaining[~inliers]
            continue
        # Remove only consumed points; keep sparse leftovers for other lines.
        keep = np.ones(len(remaining), bool)
        idx = np.where(inliers)[0]
        keep[idx[consumed]] = False
        remaining = remaining[keep]
    return segments


def merge_colinear(segments, angle_tol: float = 0.05,
                   lateral_tol: float = 0.08, gap_tol: float = 0.5):
    """Merge near-colinear, overlapping/adjacent segments.

    Sequential RANSAC can emit several pieces of one wall (and near-duplicate
    lines from leftover points); this joins segments whose directions agree
    within angle_tol (radians), whose lateral offset is within lateral_tol,
    and whose extents overlap or come within gap_tol of each other.
    """
    segs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
            for a, b in segments]
    merged = True
    while merged:
        merged = False
        out = []
        used = [False] * len(segs)
        for i in range(len(segs)):
            if used[i]:
                continue
            a1, b1 = segs[i]
            d1 = b1 - a1
            len1 = np.linalg.norm(d1)
            if len1 < 1e-9:
                used[i] = True
                continue
            u1 = d1 / len1
            for j in range(i + 1, len(segs)):
                if used[j]:
                    continue
                a2, b2 = segs[j]
                d2 = b2 - a2
                len2 = np.linalg.norm(d2)
                if len2 < 1e-9:
                    used[j] = True
                    continue
                u2 = d2 / len2
                if abs(abs(u1 @ u2) - 1.0) > angle_tol ** 2 / 2 and \
                        np.arccos(min(abs(u1 @ u2), 1.0)) > angle_tol:
                    continue
                n1 = np.array([-u1[1], u1[0]])
                if max(abs((a2 - a1) @ n1), abs((b2 - a1) @ n1)) > lateral_tol:
                    continue
                t_vals = [0.0, len1, (a2 - a1) @ u1, (b2 - a1) @ u1]
                lo2, hi2 = sorted(t_vals[2:])
                if lo2 > len1 + gap_tol or hi2 < -gap_tol:
                    continue
                t_min, t_max = min(t_vals), max(t_vals)
                a1, b1 = a1 + t_min * u1, a1 + t_max * u1
                d1 = b1 - a1
                len1 = np.linalg.norm(d1)
                u1 = d1 / len1
                used[j] = True
                merged = True
            used[i] = True
            out.append((a1, b1))
        segs = out
    return segs


def join_corners(segments, max_gap: float = 0.5, min_angle: float = 0.3):
    """Snap endpoints of nearby non-colinear segments to their line
    intersection, closing wall corners RANSAC leaves slightly open.

    Two segments whose directions differ by at least min_angle (radians)
    and whose nearest endpoints lie within max_gap are both extended (or
    trimmed) to the intersection of their infinite lines, provided the
    intersection is itself within max_gap of both endpoints.
    """
    segs = [[np.asarray(a, np.float64).copy(), np.asarray(b, np.float64).copy()]
            for a, b in segments]
    for i in range(len(segs)):
        for j in range(i + 1, len(segs)):
            a1, b1 = segs[i]
            a2, b2 = segs[j]
            d1, d2 = b1 - a1, b2 - a2
            l1, l2 = np.linalg.norm(d1), np.linalg.norm(d2)
            if l1 < 1e-9 or l2 < 1e-9:
                continue
            u1, u2 = d1 / l1, d2 / l2
            cross = u1[0] * u2[1] - u1[1] * u2[0]
            if np.arcsin(min(abs(cross), 1.0)) < min_angle:
                continue          # near-colinear: merge_colinear's job
            for ei in (0, 1):
                for ej in (0, 1):
                    p, q = segs[i][ei], segs[j][ej]
                    if np.linalg.norm(p - q) > max_gap:
                        continue
                    t = np.linalg.solve(np.stack([u1, -u2], axis=1), a2 - a1)
                    x = a1 + t[0] * u1
                    if (np.linalg.norm(x - p) <= max_gap
                            and np.linalg.norm(x - q) <= max_gap):
                        segs[i][ei] = x.copy()
                        segs[j][ej] = x.copy()
    return [(a, b) for a, b in segs]


def polyline_chains(segments, tol: float = 0.05):
    """Group segments sharing endpoints (within tol) into polylines.

    Returns a list of [k, 2] float arrays; a closed loop repeats its first
    vertex at the end.  Purely an analysis/visualization view — the CSV
    output contract stays per-segment (solver.cc:608-618).
    """
    if not segments:
        return []
    ends = np.array([[a, b] for a, b in segments], np.float64)  # [S, 2, 2]
    flat = ends.reshape(-1, 2)                                  # [2S, 2]
    # Union endpoints within tol (segment counts are small; O(n^2) is fine).
    parent = list(range(len(flat)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    d = np.linalg.norm(flat[:, None, :] - flat[None, :, :], axis=-1)
    for i, j in zip(*np.nonzero(d <= tol)):
        if i < j:
            parent[find(int(j))] = find(int(i))
    node_of = [find(k) for k in range(len(flat))]
    # Adjacency: node -> [(other_node, seg_idx)]
    adj = {}
    for s in range(len(segments)):
        na, nb = node_of[2 * s], node_of[2 * s + 1]
        adj.setdefault(na, []).append((nb, s))
        adj.setdefault(nb, []).append((na, s))
    used = [False] * len(segments)
    chains = []

    def walk(start):
        chain = [flat[start]]
        node = start
        while True:
            nxt = next(((n, s) for n, s in adj[node] if not used[s]), None)
            if nxt is None:
                break
            node, seg = nxt
            used[seg] = True
            chain.append(flat[node])
        return chain

    # Open chains first (start at odd-degree nodes), then leftover cycles.
    for node in sorted(adj, key=lambda n: flat[n].tolist()):
        if len([1 for _, s in adj[node] if not used[s]]) % 2 == 1:
            chains.append(np.array(walk(node)))
    for s in range(len(segments)):
        if not used[s]:
            chains.append(np.array(walk(node_of[2 * s])))
    return chains


def fused_cloud(state) -> np.ndarray:
    """All clouds transformed by the current solution (solver.cc:584-589);
    the device clouds are read to the host in float64."""
    pts = state.problem.points.detach().cpu().numpy().astype(np.float64)
    mask = state.problem.points_mask.detach().cpu().numpy()
    out = []
    for i in range(state.num_nodes):
        p = pts[i][mask[i]]
        th = state.solution[i, 2]
        c, s = np.cos(th), np.sin(th)
        r = np.array([[c, -s], [s, c]])
        out.append(p @ r.T + state.solution[i, :2])
    return np.concatenate(out, axis=0)


def vectorize(state, map_output_file=None, verbose: bool = True,
              merge: bool = True, corners: bool = True, **extract_kw):
    """Full Vectorize flow (solver.cc:581-624): fuse, extract, write CSV."""
    cloud = fused_cloud(state)
    lines = extract_lines(cloud, **extract_kw)
    if merge:
        lines = merge_colinear(lines)
    if corners:
        lines = join_corners(lines)
    if verbose:
        print(f"Created map: Pointcloud size: {len(cloud)}\t"
              f"Lines size: {len(lines)}")
    if map_output_file:
        rows = [f"{a[0]},{a[1]},{b[0]},{b[1]}" for a, b in lines]
        Path(map_output_file).write_text("\n".join(rows) + "\n")
    return lines
