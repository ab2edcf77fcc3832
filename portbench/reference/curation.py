"""The plain reference of a curation step: plain PyTorch in float64 on the
CPU, with TF32 off while it runs.

A curator draws two line segments, A and B, on the solved map ("these two
walls are one wall"), as the upstream's HitlSlamInputMsg carries them.  The
upstream then:

- selects the poses whose clouds lie on the lines: a point within the line
  width of A counts for A; a point counts for B only if it is not on A
  (else-if); a pose with at least the threshold's points on A joins A, and
  one with that many on B joins B only if it did not join A;
- swaps the odometry for factors between every pair of poses within the
  largest window, carrying the current solution's relative poses
  (world-frame translation difference, unwrapped heading difference);
- adds one free line pose (identity at first) and, for every selected
  pose of both lines, the distances of its on-line points, placed in the
  world by the pose, to segment A moved by the line pose;
- solves the growing-window sweep, restores the recorded odometry and
  solves it again.

The solve is the upstream's too: nearest-feature correspondences per
window (portbench/reference/referee.py, reused here for the association
and the point, normal and odometry blocks), Ceres' Levenberg-Marquardt
schedule with the first pose held constant.

Departures from the upstream, none of which changes the minimum:

- the normal equations are dense over the 3 (n + L) unknowns (n poses, L
  line poses) and solved by ``torch.linalg.solve`` (Ceres factors them
  sparsely);
- the distances' Jacobian comes from forward-mode autodiff of the distance
  (``torch.func.jacfwd``), as Ceres' autodiff of the upstream's functor;
- a window runs for exactly the LM steps it is given, accepted or not,
  with the stop rule off: the comparison follows another engine's own
  per-window counts, so that no stop decision moves it.  Only the
  reference's own session (``sweep`` without counts and
  ``session_step``, on whose maps portbench/line_pairs.py draws a mix's
  line pairs) runs Ceres' stop rule: at most 50 steps a window,
  ending at an accepted step whose cost decrease is at most 1e-6 of the
  cost or whose mean |dx| over the poses is at most the configuration's
  stop threshold.

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from portbench.reference import referee

F64 = torch.float64


@contextlib.contextmanager
def no_tf32():
    """TF32 off for torch's matrix products while the reference runs, and
    the caller's setting back afterwards."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


class Constraint(NamedTuple):
    """One curated pair as the solve sees it: segment A [2, 2] (start, end)
    and the selected poses of both lines with their on-line points [k, 2]
    in the pose's frame."""

    seg_a: np.ndarray
    nodes: List[int]
    points: List[np.ndarray]


class Rows(NamedTuple):
    """All constraints' distance rows: one per selected pose."""

    node: torch.Tensor       # [R] pose index
    line: torch.Tensor       # [R] line pose index (0..L-1)
    points: torch.Tensor     # [R, K, 2]
    mask: torch.Tensor       # [R, K]
    seg: torch.Tensor        # [R, 2, 2] segment A of the row's constraint


def rows_of(constraints: Sequence[Constraint]) -> Rows:
    node, line, pts = [], [], []
    for k, c in enumerate(constraints):
        for v, p in zip(c.nodes, c.points):
            node.append(int(v))
            line.append(k)
            pts.append((np.asarray(p, np.float64).reshape(-1, 2),
                        np.asarray(c.seg_a, np.float64)))
    r = len(node)
    kmax = max([len(p) for p, _ in pts] + [1])
    points = np.zeros((r, kmax, 2))
    mask = np.zeros((r, kmax), bool)
    seg = np.zeros((r, 2, 2))
    for q, (p, s) in enumerate(pts):
        points[q, :len(p)] = p
        mask[q, :len(p)] = True
        seg[q] = s
    return Rows(torch.as_tensor(node, dtype=torch.int64),
                torch.as_tensor(line, dtype=torch.int64),
                torch.as_tensor(points, dtype=F64), torch.as_tensor(mask),
                torch.as_tensor(seg, dtype=F64))


# -- geometry ---------------------------------------------------------------

def transform(pose, p):
    """Points p [..., 2] placed by pose [..., 3]."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([c * p[..., 0] - s * p[..., 1] + pose[..., 0],
                        s * p[..., 0] + c * p[..., 1] + pose[..., 1]], -1)


def segment_distance(p, a, b):
    """The upstream's point-to-segment distance: the perpendicular distance
    when the projection on the line lies within the segment's x and y
    spans, else the distance to the nearer end."""
    d = b - a
    dd = torch.sum(d * d, -1)
    t = torch.sum((p - a) * d, -1) / dd
    proj = a + t[..., None] * d

    def between(v, lo, hi):
        return ((v >= lo) & (v <= hi)) | ((v >= hi) & (v <= lo))

    inside = between(proj[..., 0], a[..., 0], b[..., 0]) \
        & between(proj[..., 1], a[..., 1], b[..., 1])
    rel = p - a
    perp = torch.abs(d[..., 0] * rel[..., 1] - d[..., 1] * rel[..., 0]) \
        / torch.sqrt(dd)
    ends = torch.minimum(torch.linalg.norm(p - a, dim=-1),
                         torch.linalg.norm(p - b, dim=-1))
    return torch.where(inside, perp, ends)


# -- selection --------------------------------------------------------------

def on_line_counts(points32, mask, x, seg_a, seg_b, width):
    """Per pose, the points on A and on B (else-if) at ``width``: ([N],
    [N]) counts and the [N, P] masks."""
    world = transform(torch.as_tensor(x, dtype=F64)[:, None, :],
                      torch.as_tensor(points32).to(F64))
    m = torch.as_tensor(mask)
    sa = torch.as_tensor(np.asarray(seg_a), dtype=F64)
    sb = torch.as_tensor(np.asarray(seg_b), dtype=F64)
    on_a = m & (segment_distance(world, sa[0], sa[1]) <= width)
    on_b = m & ~on_a & (segment_distance(world, sb[0], sb[1]) <= width)
    return (on_a.sum(1).numpy(), on_b.sum(1).numpy(), on_a.numpy(),
            on_b.numpy())


def decisions(points32, mask, x, seg_a, seg_b, width, threshold):
    """([N] joins A, [N] joins B) with the else-if rules."""
    ca, cb, _, _ = on_line_counts(points32, mask, x, seg_a, seg_b, width)
    on_a = ca >= threshold
    return on_a, (cb >= threshold) & ~on_a


def selected_points(points32, mask, x, seg_a, seg_b, width, threshold):
    """The Constraint the selection makes from poses x."""
    ca, cb, on_a, on_b = on_line_counts(points32, mask, x, seg_a, seg_b,
                                        width)
    a = np.nonzero(ca >= threshold)[0]
    b = np.nonzero((cb >= threshold) & (ca < threshold))[0]
    pts = points32.astype(np.float64)
    return Constraint(np.asarray(seg_a, np.float64), list(a) + list(b),
                      [pts[v][on_a[v]] for v in a]
                      + [pts[v][on_b[v]] for v in b])


# -- factors ----------------------------------------------------------------

def densified_odometry(x, max_window, tw, rw) -> referee.Factors:
    """A factor between every pair of poses within max_window, carrying
    x's world-frame translation and unwrapped heading differences."""
    n = len(x)
    i, j = [], []
    for b in range(1, n):
        for a in range(max(b - max_window, 0), b):
            i.append(a)
            j.append(b)
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    return referee.odometry(i, j, x[j, :2] - x[i, :2], x[j, 2] - x[i, 2],
                            tw, rw)


def _row_distances(pose, line_pose, points, mask, seg):
    """[K] distances of one row's points to its segment A moved by the
    line pose."""
    a = transform(line_pose, seg[0])
    b = transform(line_pose, seg[1])
    return segment_distance(transform(pose, points), a, b) * mask.to(F64)


def hitl_rows(x, lines, rows: Rows, jac=True):
    """(r [R, K], J [R, K, 6] over (pose, line pose), or None)."""
    p6 = torch.cat([x[rows.node], lines[rows.line]], -1)

    def f(p, pts, m, s):
        return _row_distances(p[:3], p[3:], pts, m, s)

    r = torch.vmap(f)(p6, rows.points, rows.mask, rows.seg)
    if not jac:
        return r, None
    return r, torch.vmap(torch.func.jacfwd(f))(p6, rows.points, rows.mask,
                                               rows.seg)


def _blocks(prob, x, lines, planar, edge, factors, rows, jac=True):
    """Residual groups (dof columns [Q, 6], J [Q, m, 6], r [Q, m])."""
    out = []
    for nodes, J, r in referee.evaluate(prob, x.numpy(), planar, edge,
                                        factors, jac):
        nodes = torch.as_tensor(nodes)
        dof = (3 * nodes[:, :, None] + torch.arange(3)).reshape(-1, 6)
        out.append((dof, None if J is None else torch.as_tensor(J),
                    torch.as_tensor(r)))
    if rows is not None and len(rows.node):
        r, J = hitl_rows(x, lines, rows, jac)
        n = x.shape[0]
        dof = torch.cat([3 * rows.node[:, None] + torch.arange(3),
                         3 * (n + rows.line[:, None]) + torch.arange(3)], 1)
        out.append((dof, J, r))
    return out


def _cost(blocks):
    return 0.5 * float(sum(torch.sum(r * r) for _, _, r in blocks))


def _normal_equations(blocks, size):
    H = torch.zeros(size * size, dtype=F64)
    g = torch.zeros(size, dtype=F64)
    for dof, J, r in blocks:
        Hq = torch.einsum("qmi,qmj->qij", J, J)
        gq = torch.einsum("qmi,qm->qi", J, r)
        flat = (dof[:, :, None] * size + dof[:, None, :]).reshape(-1)
        H.index_add_(0, flat, Hq.reshape(-1))
        g.index_add_(0, dof.reshape(-1), gq.reshape(-1))
    return H.reshape(size, size), g


# -- Levenberg-Marquardt ----------------------------------------------------

def lm(prob, x0, lines0, planar, edge, factors, rows, iterations,
       min_relative_decrease=1e-3, initial_radius=1e4, min_diagonal=1e-6,
       max_diagonal=1e32, stop=None):
    """Ceres' trust-region schedule on the dense normal equations, pose 0
    held constant, for exactly ``iterations`` steps, accepted or not, the
    stop rule off; with ``stop`` (the step tolerance) at most
    ``iterations`` steps under Ceres' stop rule.  Returns (x [n, 3],
    lines [L, 3], cost)."""
    n, L = len(x0), len(lines0)
    size = 3 * (n + L)
    x = torch.as_tensor(np.asarray(x0), dtype=F64).clone()
    lines = torch.as_tensor(np.asarray(lines0), dtype=F64).reshape(L, 3)
    blocks = _blocks(prob, x, lines, planar, edge, factors, rows)
    cost = _cost(blocks)
    free = torch.ones(size, dtype=torch.bool)
    free[:3] = False
    radius, divisor = initial_radius, 2.0
    for _ in range(iterations):
        H, g = _normal_equations(blocks, size)
        Hf, gf = H[free][:, free], g[free]
        d = torch.clamp(torch.diagonal(Hf), min_diagonal, max_diagonal)
        dxf = torch.linalg.solve(Hf + torch.diag(d / radius), -gf)
        dx = torch.zeros(size, dtype=F64)
        dx[free] = dxf
        if not bool(torch.all(torch.isfinite(dx))):
            radius /= divisor
            divisor *= 2
            continue
        x_new = x + dx[:3 * n].reshape(n, 3)
        l_new = lines + dx[3 * n:].reshape(L, 3)
        new_cost = _cost(_blocks(prob, x_new, l_new, planar, edge, factors,
                                 rows, jac=False))
        model = -float(gf @ dxf + 0.5 * dxf @ (Hf @ dxf))
        rho = (cost - new_cost) / max(model, 1e-300)
        if model > 0 and rho > min_relative_decrease:
            decrease = cost - new_cost
            x, lines, cost = x_new, l_new, new_cost
            blocks = _blocks(prob, x, lines, planar, edge, factors, rows)
            radius = min(radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3), 1e16)
            divisor = 2.0
            if stop is not None and (
                    abs(decrease) <= 1e-6 * (cost + decrease)
                    or float(torch.mean(torch.abs(dx[:3 * n]))) <= stop):
                break
        else:
            radius /= divisor
            divisor *= 2
    return x.numpy(), lines.numpy(), cost


def sweep(prob, x0, lines0, cfg: referee.Settings, factors, rows,
          iterations: Optional[Sequence[int]]):
    """The growing-window solve, windows cfg.w_min..cfg.w_max, each
    associating at the current poses and running its ``iterations`` entry
    of LM steps (None: Ceres' stop rule in every window).  Returns (x,
    lines)."""
    x, lines = np.asarray(x0, np.float64), np.asarray(lines0, np.float64)
    windows = range(cfg.w_min, cfg.w_max + 1)
    with no_tf32():
        for w, steps in zip(windows, iterations or [None] * len(windows)):
            planar, edge = referee.associate(prob, x, w, cfg.outlier)
            if steps is None:
                x, lines, _ = lm(prob, x, lines, planar, edge, factors, rows,
                                 50, stop=cfg.step_tolerance)
            else:
                x, lines, _ = lm(prob, x, lines, planar, edge, factors, rows,
                                 int(steps))
    return x, lines


def session_step(prob, cfg: referee.Settings, odo, points32, mask, x, lines,
                 constraints: List[Constraint], seg_a, seg_b, width,
                 threshold):
    """One curation step of the reference's own session, the upstream's
    callback: select from x, solve with the odometry densified from x and
    every constraint so far, then again with the recorded odometry, each
    sweep under the stop rule.  Returns (x, lines, constraints)."""
    constraints = constraints + [selected_points(
        points32, mask, x, seg_a, seg_b, width, threshold)]
    rows = rows_of(constraints)
    lines = np.concatenate([np.asarray(lines).reshape(-1, 3),
                            np.zeros((1, 3))])
    dense = densified_odometry(x, cfg.w_max, cfg.tw, cfg.rw)
    x, lines = sweep(prob, x, lines, cfg, dense, rows, None)
    x, lines = sweep(prob, x, lines, cfg, odo, rows, None)
    return x, lines, constraints


def window_gap(prob, cfg: referee.Settings, window, factors, rows, start,
               end, iterations):
    """One window of another engine's solve against this reference's: from
    that engine's (poses, line poses) ``start``, under the correspondences
    at ``start``, ``iterations`` LM steps with the stop rule off; the
    relative gap of the cost at ``end`` (the other engine's window end) to
    the cost where the reference ends."""
    with no_tf32():
        planar, edge = referee.associate(prob, start[0], window, cfg.outlier)
        _, _, c_ref = lm(prob, start[0], start[1], planar, edge, factors,
                         rows, iterations)
        c_end = _cost(_blocks(prob, torch.as_tensor(end[0], dtype=F64),
                              torch.as_tensor(end[1], dtype=F64)
                              .reshape(-1, 3), planar, edge, factors, rows,
                              jac=False))
    return abs(c_end - c_ref) / c_ref


def cost_at(prob, x, lines, cfg: referee.Settings, factors, rows=None):
    """The cost with the constraints' rows at (x, lines), under x's own
    largest-window correspondences: the yardstick of two solutions."""
    with no_tf32():
        planar, edge = referee.associate(prob, x, cfg.w_max, cfg.outlier)
        return _cost(_blocks(prob, torch.as_tensor(x, dtype=F64),
                             torch.as_tensor(np.asarray(lines), dtype=F64)
                             .reshape(-1, 3), planar, edge, factors, rows,
                             jac=False))
