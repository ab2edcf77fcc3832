"""Residual factors + Gauss-Newton normal equations, in block-band and in
dense form (port of nautilus_tpu/solve/factors.py).

Residuals (same semantics as the JAX package):
- odometry: world-frame translation delta plus wrapped rotation delta,
  scaled by the translation/rotation weights;
- normal: the source point moved into the target frame, projected onto the
  target normal and onto the (unrotated) source normal;
- point: plain 2D point difference in the target frame;
- HITL: distance of each pose-transformed point to a human-drawn segment
  that is itself moved by a free SE(2) line pose.

The dof vector is x [N + L, 3]: N node poses, then L HITL line poses.

Assembly writes H = J^T J and g = J^T r straight into the block band (3x3
blocks, half-bandwidth w) that solve/band.py factors.  Correspondence
factors accumulate by the delta-major pair order as contiguous slice adds;
odometry (and in-band loop closures) scatter into the band; long-range
loop closures become Woodbury columns U with H_lr = U U^T; HITL factors
couple nodes to line poses through the dense border C, E, gl.

``analytic="moments"`` (the solver's default) reduces J^T J and J^T r of
the correspondence factors to per-point scalar sums without forming J;
``analytic=True`` forms the closed-form J and contracts it.

``assemble_normal_equations`` builds the same system as a dense [3M, 3M] H
for graphs the band cannot hold (odometry outside the window, more
long-range closures than the Woodbury cap): every factor batch is
linearized to (r, J, dof) and its 6x6 blocks scattered into H.  With a
layout the correspondence blocks take the band accumulation and one
band-to-dense expansion instead.  The same (r, J, dof) terms drive the
matrix-free products of solve/cg.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nautilus_tpu_torch.core import geometry as geo


class OdomFactors(NamedTuple):
    """[F] odometry-style factors with per-factor weights."""

    i: torch.Tensor        # [F] int64
    j: torch.Tensor        # [F] int64
    trans: torch.Tensor    # [F, 2] world-frame translation i -> j
    rot: torch.Tensor      # [F]
    mask: torch.Tensor     # [F] bool
    wt: torch.Tensor       # [F] translation weight
    wr: torch.Tensor       # [F] rotation weight
    # Largest |i - j|, kept on the host so that the band assembly can refuse
    # an out-of-band factor without reading the device.
    span: int = 0

    @property
    def count(self):
        return self.i.shape[0]


def make_odom_factors(i, j, trans, rot, tw, rw, device,
                      dtype=torch.float32) -> OdomFactors:
    """Factors from host arrays; tw/rw are scalars or per-factor arrays."""
    host = [np.asarray(v.cpu() if torch.is_tensor(v) else v,
                       np.int64).reshape(-1) for v in (i, j)]
    span = int(np.abs(host[0] - host[1]).max()) if host[0].size else 0
    i = torch.as_tensor(i, dtype=torch.int64, device=device).reshape(-1)
    f = i.shape[0]
    full = lambda v: torch.as_tensor(v, dtype=dtype, device=device).expand(f)
    return OdomFactors(
        i=i, j=torch.as_tensor(j, dtype=torch.int64, device=device).reshape(-1),
        trans=torch.as_tensor(trans, dtype=dtype, device=device).reshape(f, 2),
        rot=torch.as_tensor(rot, dtype=dtype, device=device).reshape(f),
        mask=torch.ones((f,), dtype=torch.bool, device=device),
        wt=full(tw).clone(), wr=full(rw).clone(), span=span)


class Correspondences(NamedTuple):
    """[Q, S] point matches between pose pairs (one row per pair)."""

    src: torch.Tensor       # [Q] source node index
    tgt: torch.Tensor       # [Q] target node index
    src_pts: torch.Tensor   # [Q, S, 2] in the source scan frame
    tgt_pts: torch.Tensor   # [Q, S, 2] in the target scan frame
    src_nrm: torch.Tensor   # [Q, S, 2]
    tgt_nrm: torch.Tensor   # [Q, S, 2]
    mask: torch.Tensor      # [Q, S] bool (slot and pair validity)


class HitlFactors(NamedTuple):
    """[R, K] HITL colinearity participations (one row per constrained pose).

    Each row ties one node's on-line points to one free line pose.  As in
    the reference, the *line A* segment serves the poses of both lines: the
    constraint merges the two walls into one."""

    node: torch.Tensor        # [R] int64 node index
    line: torch.Tensor        # [R] int64 dof index of the line pose (>= N)
    points: torch.Tensor      # [R, K, 2] points in the node's scan frame
    mask: torch.Tensor        # [R, K] bool
    seg_start: torch.Tensor   # [R, 2] segment ends in the line pose's frame
    seg_end: torch.Tensor     # [R, 2]


def empty_hitl(device, dtype=torch.float32) -> HitlFactors:
    return HitlFactors(
        node=torch.zeros((0,), dtype=torch.int64, device=device),
        line=torch.zeros((0,), dtype=torch.int64, device=device),
        points=torch.zeros((0, 1, 2), dtype=dtype, device=device),
        mask=torch.zeros((0, 1), dtype=torch.bool, device=device),
        seg_start=torch.zeros((0, 2), dtype=dtype, device=device),
        seg_end=torch.zeros((0, 2), dtype=dtype, device=device))


class FactorGraph(NamedTuple):
    odom: OdomFactors
    planar: Correspondences   # -> normal residuals
    edge: Correspondences     # -> point residuals
    hitl: Optional[HitlFactors] = None   # -> point-to-segment residuals


class BandedSystem(NamedTuple):
    """Normal equations in block-band(+border) form (solve/band.py)."""

    diag: torch.Tensor             # [N, 3, 3] block (i, i)
    band: torch.Tensor             # [w, N, 3, 3] band[d-1][i] = block (i, i-d)
    g: torch.Tensor                # [N, 3]
    U: Optional[torch.Tensor] = None   # [3N, R] long-range Woodbury columns
    C: Optional[torch.Tensor] = None   # [N, L, 3, 3] node-line border blocks
    E: Optional[torch.Tensor] = None   # [L, 3, 3] line-line diagonal blocks
    gl: Optional[torch.Tensor] = None  # [L, 3] gradient on line dofs

    @property
    def n(self):
        return self.diag.shape[0]

    @property
    def w(self):
        return self.band.shape[0]

    @property
    def rank_lr(self):
        return 0 if self.U is None else self.U.shape[1]

    @property
    def num_lines(self):
        return 0 if self.C is None else self.C.shape[1]


# ---------------------------------------------------------------------------
# Residuals and cost
# ---------------------------------------------------------------------------

def odom_residual(pose_i, pose_j, trans, rot, mask, tw, rw):
    """[F, 3] weighted odometry residuals."""
    et = pose_i[:, :2] + trans - pose_j[:, :2]
    dr = pose_i[:, 2] + rot - pose_j[:, 2]
    er = torch.atan2(torch.sin(dr), torch.cos(dr))
    m = mask.to(pose_i.dtype)
    return torch.stack([tw * et[:, 0], tw * et[:, 1], rw * er], dim=-1) \
        * m[:, None]


def normal_residual(pose_s, pose_t, src_pts, tgt_pts, src_nrm, tgt_nrm,
                    mask):
    """[Q, S, 2] signed point-to-plane residuals."""
    p_t = geo.relative_pose_transform_points(pose_s[:, None], pose_t[:, None],
                                             src_pts)
    diff = p_t - tgt_pts
    r_tgt = torch.sum(tgt_nrm * diff, dim=-1)
    r_src = torch.sum(src_nrm * (-diff), dim=-1)
    m = mask.to(pose_s.dtype)
    return torch.stack([r_tgt * m, r_src * m], dim=-1)


def point_residual(pose_s, pose_t, src_pts, tgt_pts, mask):
    """[Q, S, 2] point-difference residuals."""
    p_t = geo.relative_pose_transform_points(pose_s[:, None], pose_t[:, None],
                                             src_pts)
    return (tgt_pts - p_t) * mask[..., None].to(pose_s.dtype)


def hitl_residual(pose_node, pose_line, points, mask, seg_start, seg_end):
    """[K] point-to-segment distances of one HITL row: the node's points in
    the world against the segment moved by the line pose."""
    world = geo.pose_transform_points(pose_node, points)
    a = geo.pose_transform_points(pose_line, seg_start)
    b = geo.pose_transform_points(pose_line, seg_end)
    return geo.distance_to_line_segment(world, a, b) * mask.to(pose_node.dtype)


def total_cost(x, graph: FactorGraph):
    """Ceres-convention total cost: 0.5 * sum of squared residuals."""
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    od = graph.odom
    if od.count:
        r = odom_residual(x[od.i], x[od.j], od.trans, od.rot, od.mask, od.wt,
                          od.wr)
        acc = acc + torch.sum(r * r)
    pl, ed = graph.planar, graph.edge
    if pl.src.shape[0]:
        r = normal_residual(x[pl.src], x[pl.tgt], pl.src_pts, pl.tgt_pts,
                            pl.src_nrm, pl.tgt_nrm, pl.mask)
        acc = acc + torch.sum(r * r)
    if ed.src.shape[0]:
        r = point_residual(x[ed.src], x[ed.tgt], ed.src_pts, ed.tgt_pts,
                           ed.mask)
        acc = acc + torch.sum(r * r)
    h = graph.hitl
    if h is not None and h.node.shape[0]:
        r = torch.vmap(hitl_residual)(x[h.node], x[h.line], h.points, h.mask,
                                      h.seg_start, h.seg_end)
        acc = acc + torch.sum(r * r)
    return 0.5 * acc


# ---------------------------------------------------------------------------
# Closed-form linearization
# ---------------------------------------------------------------------------

def _dof_cols(idx_a, idx_b):
    k = torch.arange(3, device=idx_a.device)
    return torch.cat([3 * idx_a[:, None] + k, 3 * idx_b[:, None] + k],
                     dim=1)                                   # [Q, 6]


def _pt_geometry(pose_s, pose_t, src_pts):
    """Transformed points p_t and the two point-dependent Jacobian columns
    a3 = R_t^T R'(th_s) p and a6 = [p_t.y, -p_t.x]; the other four columns
    are per-pair rotation constants (+-R_t^T e_x, +-R_t^T e_y)."""
    c_s, s_s = torch.cos(pose_s[:, 2:3]), torch.sin(pose_s[:, 2:3])
    c_t, s_t = torch.cos(pose_t[:, 2:3]), torch.sin(pose_t[:, 2:3])
    px, py = src_pts[..., 0], src_pts[..., 1]                 # [Q, S]
    wx = c_s * px - s_s * py + pose_s[:, 0:1]
    wy = s_s * px + c_s * py + pose_s[:, 1:2]
    dx, dy = wx - pose_t[:, 0:1], wy - pose_t[:, 1:2]
    ptx = c_t * dx + s_t * dy
    pty = -s_t * dx + c_t * dy
    rpx = -s_s * px - c_s * py          # R'(th_s) p
    rpy = c_s * px - s_s * py
    a3x = c_t * rpx + s_t * rpy
    a3y = -s_t * rpx + c_t * rpy
    return ptx, pty, a3x, a3y, c_t, s_t


def _pt_and_jacobian(pose_s, pose_t, src_pts):
    """p_t [Q, S, 2] and A = dp_t / d(pose_s, pose_t) [Q, S, 2, 6]."""
    ptx, pty, a3x, a3y, c_t, s_t = _pt_geometry(pose_s, pose_t, src_pts)
    one = torch.ones_like(ptx)
    cols = [
        torch.stack([c_t * one, -s_t * one], -1),
        torch.stack([s_t * one, c_t * one], -1),
        torch.stack([a3x, a3y], -1),
        torch.stack([-c_t * one, s_t * one], -1),
        torch.stack([-s_t * one, -c_t * one], -1),
        torch.stack([pty, -ptx], -1),
    ]
    return torch.stack([ptx, pty], -1), torch.stack(cols, dim=-1)


def _linearize_point(pose_s, pose_t, src_pts, tgt_pts, mask):
    """(r [Q, 2S], J [Q, 2S, 6]) of point_residual."""
    p_t, A = _pt_and_jacobian(pose_s, pose_t, src_pts)
    m = mask.to(pose_s.dtype)
    r = (tgt_pts - p_t) * m[..., None]
    J = -A * m[..., None, None]
    q, s = src_pts.shape[:2]
    return r.reshape(q, 2 * s), J.reshape(q, 2 * s, 6)


def _linearize_normal(pose_s, pose_t, src_pts, tgt_pts, src_nrm, tgt_nrm,
                      mask):
    """(r [Q, 2S], J [Q, 2S, 6]) of normal_residual."""
    p_t, A = _pt_and_jacobian(pose_s, pose_t, src_pts)
    m = mask.to(pose_s.dtype)
    diff = p_t - tgt_pts
    r_tgt = torch.sum(tgt_nrm * diff, dim=-1) * m
    r_src = -torch.sum(src_nrm * diff, dim=-1) * m
    J_tgt = torch.sum(tgt_nrm[..., None] * A, dim=-2) * m[..., None]
    J_src = -torch.sum(src_nrm[..., None] * A, dim=-2) * m[..., None]
    q, s = src_pts.shape[:2]
    r = torch.stack([r_tgt, r_src], dim=-1).reshape(q, 2 * s)
    J = torch.stack([J_tgt, J_src], dim=-2).reshape(q, 2 * s, 6)
    return r, J


def _linearize_odom(pose_i, pose_j, trans, rot, mask, tw, rw):
    """(r [F, 3], J [F, 3, 6]) of odom_residual."""
    r = odom_residual(pose_i, pose_j, trans, rot, mask, tw, rw)
    m = mask.to(pose_i.dtype)
    z = torch.zeros_like(tw)
    rows = torch.stack([
        torch.stack([tw, z, z, -tw, z, z], -1),
        torch.stack([z, tw, z, z, -tw, z], -1),
        torch.stack([z, z, rw, z, z, -rw], -1),
    ], dim=-2)                                   # [F, 3, 6]
    return r, rows * m[:, None, None]


def hitl_factor_spec(graph: FactorGraph):
    """(idx_a, idx_b, residual_fn, data) of the HITL batch (None if empty)."""
    h = graph.hitl
    if h is None or h.node.shape[0] == 0:
        return None
    return (h.node, h.line, hitl_residual,
            (h.points, h.mask, h.seg_start, h.seg_end))


def linearize_two_pose_jacfwd(x, idx_a, idx_b, item_fn, data):
    """(r [Q, m], J [Q, m, 6]) of a two-pose residual by forward-mode
    autodiff, for residuals without a closed form (HITL's clamped
    point-to-segment distance), as the JAX package does."""
    p6 = torch.cat([x[idx_a], x[idx_b]], dim=-1)                  # [Q, 6]

    def f(p, *d):
        return item_fn(p[:3], p[3:], *d).reshape(-1)

    r = torch.vmap(f)(p6, *data)
    J = torch.vmap(torch.func.jacfwd(f))(p6, *data)
    return r, J


_ANALYTIC = {
    odom_residual: _linearize_odom,
    point_residual: _linearize_point,
    normal_residual: _linearize_normal,
}


def linearize_two_pose(x, idx_a, idx_b, item_fn, data):
    """(r [Q, m], J [Q, m, 6], dof [Q, 6]) of one two-pose factor batch, or
    None when it is empty: the closed form for odometry, point and normal
    residuals, forward-mode autodiff for the rest (HITL)."""
    if idx_a.shape[0] == 0:
        return None
    closed_form = _ANALYTIC.get(item_fn)
    if closed_form is not None:
        r, J = closed_form(x[idx_a], x[idx_b], *data)
    else:
        r, J = linearize_two_pose_jacfwd(x, idx_a, idx_b, item_fn, data)
    return r, J, _dof_cols(idx_a, idx_b)


def odom_factor_spec(graph: FactorGraph):
    """(idx_a, idx_b, residual_fn, data) of the odometry batch."""
    od = graph.odom
    return (od.i, od.j, odom_residual,
            (od.trans, od.rot, od.mask, od.wt, od.wr))


def corr_factor_specs(graph: FactorGraph):
    """Factor specs of the planar and edge correspondence batches."""
    pl, ed = graph.planar, graph.edge
    return [
        (pl.src, pl.tgt, normal_residual,
         (pl.src_pts, pl.tgt_pts, pl.src_nrm, pl.tgt_nrm, pl.mask)),
        (ed.src, ed.tgt, point_residual, (ed.src_pts, ed.tgt_pts, ed.mask)),
    ]


def graph_factor_specs(graph: FactorGraph):
    """Every factor type as (idx_a, idx_b, residual_fn, data): the one
    enumeration the dense scatter and the matrix-free products build
    from."""
    hitl = hitl_factor_spec(graph)
    return [odom_factor_spec(graph)] + corr_factor_specs(graph) \
        + ([] if hitl is None else [hitl])


def _graph_factor_terms(x, graph: FactorGraph):
    """(r, J, dof) of every non-empty factor batch."""
    terms = [linearize_two_pose(x, *spec)
             for spec in graph_factor_specs(graph)]
    return [t for t in terms if t is not None]


def _jtj(r, J):
    """(Hq [Q, 6, 6], gq [Q, 6]) = (J^T J, J^T r)."""
    return (torch.einsum("qmi,qmj->qij", J, J),
            torch.einsum("qmi,qm->qi", J, r))


# ---------------------------------------------------------------------------
# Moment form: J^T J and J^T r from per-point scalar sums
# ---------------------------------------------------------------------------

def _sym6(entries):
    """[Q, 6, 6] from the upper-triangle dict {(i, j): [Q]}."""
    rows = [torch.stack([entries[(min(i, j), max(i, j))] for j in range(6)],
                        dim=-1) for i in range(6)]
    return torch.stack(rows, dim=-2)


def _moments_point(pose_s, pose_t, src_pts, tgt_pts, mask):
    """(Hq [Q,6,6], gq [Q,6], cost) of point_residual via moments."""
    ptx, pty, a3x, a3y, c_t, s_t = _pt_geometry(pose_s, pose_t, src_pts)
    m = mask.to(pose_s.dtype)
    a6x, a6y = pty, -ptx
    rx = (tgt_pts[..., 0] - ptx) * m
    ry = (tgt_pts[..., 1] - pty) * m
    red = lambda t: torch.sum(t, dim=-1)
    M0 = red(m)
    S3x, S3y = red(m * a3x), red(m * a3y)
    S6x, S6y = red(m * a6x), red(m * a6y)
    s33 = red(m * (a3x * a3x + a3y * a3y))
    s36 = red(m * (a3x * a6x + a3y * a6y))
    s66 = red(m * (a6x * a6x + a6y * a6y))
    Srx, Sry = red(rx), red(ry)
    g3r = red(a3x * rx + a3y * ry)
    g6r = red(a6x * rx + a6y * ry)
    cost = 0.5 * torch.sum(rx * rx + ry * ry)
    ct, st = c_t[:, 0], s_t[:, 0]
    h13 = ct * S3x - st * S3y
    h23 = st * S3x + ct * S3y
    h16 = ct * S6x - st * S6y
    h26 = st * S6x + ct * S6y
    z = torch.zeros_like(M0)
    Hq = _sym6({(0, 0): M0, (0, 1): z, (0, 2): h13, (0, 3): -M0,
                (0, 4): z, (0, 5): h16,
                (1, 1): M0, (1, 2): h23, (1, 3): z, (1, 4): -M0,
                (1, 5): h26,
                (2, 2): s33, (2, 3): -h13, (2, 4): -h23, (2, 5): s36,
                (3, 3): M0, (3, 4): z, (3, 5): -h16,
                (4, 4): M0, (4, 5): -h26,
                (5, 5): s66})
    g1 = -(ct * Srx - st * Sry)
    g2 = -(st * Srx + ct * Sry)
    gq = torch.stack([g1, g2, -g3r, -g1, -g2, -g6r], dim=-1)
    return Hq, gq, cost


def _moments_normal(pose_s, pose_t, src_pts, tgt_pts, src_nrm, tgt_nrm,
                    mask):
    """(Hq, gq, cost) of normal_residual via moments: each point gives two
    rows n^T A = [u, v, w, -u, -v, z] (target and source normal)."""
    ptx, pty, a3x, a3y, c_t, s_t = _pt_geometry(pose_s, pose_t, src_pts)
    m = mask.to(pose_s.dtype)
    dx = ptx - tgt_pts[..., 0]
    dy = pty - tgt_pts[..., 1]
    sums = None
    for nrm in (tgt_nrm, src_nrm):
        nx, ny = nrm[..., 0], nrm[..., 1]
        u = nx * c_t - ny * s_t
        v = nx * s_t + ny * c_t
        w = nx * a3x + ny * a3y
        zc = nx * pty - ny * ptx
        rr = (nx * dx + ny * dy) * m
        terms = [m * u * u, m * u * v, m * u * w, m * u * zc,
                 m * v * v, m * v * w, m * v * zc,
                 m * w * w, m * w * zc, m * zc * zc,
                 u * rr, v * rr, w * rr, zc * rr, rr * rr]
        part = [torch.sum(t, dim=-1) for t in terms]
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    (uu, uv, uw, uz, vv, vw, vz, ww, wz, zz,
     ur, vr, wr, zr, rr2) = sums
    Hq = _sym6({(0, 0): uu, (0, 1): uv, (0, 2): uw, (0, 3): -uu,
                (0, 4): -uv, (0, 5): uz,
                (1, 1): vv, (1, 2): vw, (1, 3): -uv, (1, 4): -vv,
                (1, 5): vz,
                (2, 2): ww, (2, 3): -uw, (2, 4): -vw, (2, 5): wz,
                (3, 3): uu, (3, 4): uv, (3, 5): -uz,
                (4, 4): vv, (4, 5): -vz,
                (5, 5): zz})
    gq = torch.stack([ur, vr, wr, -ur, -vr, zr], dim=-1)
    return Hq, gq, 0.5 * torch.sum(rr2)


# ---------------------------------------------------------------------------
# Band assembly
# ---------------------------------------------------------------------------

class BandLayout(NamedTuple):
    """The delta-major pair layout (correspond.make_pairs): pairs of delta d
    occupy rows [offsets()[d-1], offsets()[d]), i = d..n-1 ascending.
    ``w`` is min(max_window, n - 1)."""

    n: int
    w: int

    def offsets(self):
        offs = [0]
        for d in range(1, self.w + 1):
            offs.append(offs[-1] + max(self.n - d, 0))
        return offs


_MOMENTS = {
    point_residual: _moments_point,
    normal_residual: _moments_normal,
}


def _factor_blocks(x, spec, analytic):
    """(Hq [Q, 6, 6], gq [Q, 6], cost) of one two-pose factor batch
    (idx_a, idx_b, residual_fn, data): the moment form for the
    correspondence residuals when analytic == 'moments', else J^T J and
    J^T r of its linearization (analytic=True)."""
    if analytic not in ("moments", True):
        raise ValueError(f"analytic must be 'moments' or True, got "
                         f"{analytic!r}")
    idx_a, idx_b, item_fn, data = spec
    moments = _MOMENTS.get(item_fn) if analytic == "moments" else None
    if moments is not None:
        return moments(x[idx_a], x[idx_b], *data)
    r, J, _ = linearize_two_pose(x, idx_a, idx_b, item_fn, data)
    Hq, gq = _jtj(r, J)
    return Hq, gq, 0.5 * torch.sum(r * r)


def _accumulate_banded(x, graph: FactorGraph, layout: BandLayout,
                       analytic="moments"):
    """Correspondence blocks accumulated into (diag [n,3,3], band [w,n,3,3],
    gd [n,3], cost) in the delta-major order.  The moment form on a CUDA
    card runs the hand-written kernel (kernels/band_moments.py); CPU tensors
    and the Jacobian form run the plain version."""
    if analytic == "moments" and x.device.type == "cuda":
        from nautilus_tpu_torch.kernels.band_moments import band_moments
        return band_moments(x, graph.planar, graph.edge, layout)
    return _accumulate_banded_reference(x, graph, layout, analytic)


def _accumulate_banded_reference(x, graph: FactorGraph, layout: BandLayout,
                                 analytic="moments"):
    """_accumulate_banded in plain PyTorch, by contiguous slice adds."""
    n, w = layout.n, layout.w
    offs = layout.offsets()
    dt, dev = x.dtype, x.device
    diag = torch.zeros((n, 3, 3), dtype=dt, device=dev)
    band = torch.zeros((w, n, 3, 3), dtype=dt, device=dev)
    gd = torch.zeros((n, 3), dtype=dt, device=dev)
    cost = torch.zeros((), dtype=dt, device=dev)
    for spec in corr_factor_specs(graph):
        if spec[0].shape[0] == 0:
            continue
        Hq, gq, c = _factor_blocks(x, spec, analytic)
        cost = cost + c
        for d in range(1, w + 1):
            cnt = n - d
            s = offs[d - 1]
            Hd, gqd = Hq[s:s + cnt], gq[s:s + cnt]
            # Pair rows i = d..n-1 (source) against j = 0..n-1-d (target).
            diag[d:] += Hd[:, :3, :3]
            diag[:cnt] += Hd[:, 3:, 3:]
            band[d - 1, d:] += Hd[:, :3, 3:]
            gd[d:] += gqd[:, :3]
            gd[:cnt] += gqd[:, 3:]
    return diag, band, gd, cost


def _scatter_band_factor(lv, gd, cost, x, spec, analytic=True):
    """Scatter one two-pose factor batch (idx_a, idx_b, residual_fn, data)
    into the band levels lv [w+1, N, 3, 3] (level 0 = diagonal, level d =
    block (i, i-d) at row i) and the gradient gd, in any factor order.
    Requires |idx_a - idx_b| <= w (the callers check on the host)."""
    a, b = spec[0], spec[1]
    if a.shape[0] == 0:
        return lv, gd, cost
    Hq, gq, c = _factor_blocks(x, spec, analytic)
    cost = cost + c
    lo = torch.maximum(a, b)
    delta = torch.abs(a - b)
    lower = torch.where((a > b)[:, None, None], Hq[:, :3, 3:],
                        Hq[:, :3, 3:].transpose(1, 2))
    lower = torch.where((delta > 0)[:, None, None], lower,
                        torch.zeros_like(lower))
    zero = torch.zeros_like(a)
    lv = lv.index_put((zero, a), Hq[:, :3, :3], accumulate=True)
    lv = lv.index_put((zero, b), Hq[:, 3:, 3:], accumulate=True)
    lv = lv.index_put((delta, lo), lower, accumulate=True)
    gd = gd.index_put((a,), gq[:, :3], accumulate=True)
    gd = gd.index_put((b,), gq[:, 3:], accumulate=True)
    return lv, gd, cost


def lowrank_factor_columns(x, lr: OdomFactors, n: int):
    """(U [3n, 3K], g_lr [n, 3], cost) of long-range loop-closure factors:
    each factor's J^T J = (J^T)(J^T)^T, so U holds the 3K columns J^T and
    H_lr = U U^T exactly."""
    r, J = _linearize_odom(x[lr.i], x[lr.j], lr.trans, lr.rot, lr.mask,
                           lr.wt, lr.wr)
    k = r.shape[0]
    dev = x.device
    dof = _dof_cols(lr.i, lr.j)                       # [K, 6]
    cost = 0.5 * torch.sum(r * r)
    gq = torch.einsum("kmi,km->ki", J, r)             # [K, 6]
    g_lr = torch.zeros((3 * n,), dtype=x.dtype, device=dev).index_put(
        (dof.reshape(-1),), gq.reshape(-1), accumulate=True).reshape(n, 3)
    cols = 3 * torch.arange(k, device=dev)[:, None] \
        + torch.arange(3, device=dev)[None, :]        # [K, 3]
    U = torch.zeros((3 * n, 3 * k), dtype=x.dtype, device=dev).index_put(
        (dof[:, None, :].expand(k, 3, 6), cols[:, :, None].expand(k, 3, 6)),
        J, accumulate=True)
    return U, g_lr, cost


def _hitl_border(lv, gd, cost, x, graph: FactorGraph, n: int, L: int):
    """Accumulate the HITL factors: node-node blocks into the band diagonal,
    node-line blocks into the dense border C, line-line blocks into the
    block-diagonal E.  Returns (lv, gd, cost, C, E, gl)."""
    dt, dev = x.dtype, x.device
    C = torch.zeros((n, L, 3, 3), dtype=dt, device=dev)
    E = torch.zeros((L, 3, 3), dtype=dt, device=dev)
    gl = torch.zeros((L, 3), dtype=dt, device=dev)
    spec = hitl_factor_spec(graph)
    if spec is None:
        return lv, gd, cost, C, E, gl
    node, line = spec[0], spec[1] - n
    r, J = linearize_two_pose_jacfwd(x, *spec)
    Hq, gq = _jtj(r, J)
    cost = cost + 0.5 * torch.sum(r * r)
    lv = lv.index_put((torch.zeros_like(node), node), Hq[:, :3, :3],
                      accumulate=True)
    C = C.index_put((node, line), Hq[:, :3, 3:], accumulate=True)
    E = E.index_put((line,), Hq[:, 3:, 3:], accumulate=True)
    gd = gd.index_put((node,), gq[:, :3], accumulate=True)
    gl = gl.index_put((line,), gq[:, 3:], accumulate=True)
    return lv, gd, cost, C, E, gl


def _refuse_out_of_band(span: int, w: int):
    if span > w:
        raise ValueError(
            f"band assembly of a factor with |i - j| = {span} > {w}: build "
            "the graph with exclude_long_range=True and pass the long-range "
            "closures as lr, or assemble the dense system")


def assemble_banded_scatter(x, graph: FactorGraph, n: int, w: int,
                            analytic=True, *, pair_span: int):
    """Band-form assembly of a factor graph in any factor order, by scatter
    into [w+1, n, 3, 3]: (BandedSystem without U, cost).

    This is the assembly of one rank's slice of the factor lists
    (parallel/sharded.py): a contiguous slice of the delta-major pair list
    has no slice-add layout.  The summed slices equal
    assemble_banded_system on the whole graph.  Every two-node factor must
    satisfy |i - j| <= w, checked before any scatter: odometry through
    ``OdomFactors.span``, correspondences through ``pair_span`` (their
    largest |src - tgt|, which the caller knows on the host).  HITL rows
    enter as the border C, E, gl."""
    _refuse_out_of_band(graph.odom.span, w)
    _refuse_out_of_band(pair_span, w)
    L = x.shape[0] - n
    lv = torch.zeros((w + 1, n, 3, 3), dtype=x.dtype, device=x.device)
    gd = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    for spec in corr_factor_specs(graph) + [odom_factor_spec(graph)]:
        lv, gd, cost = _scatter_band_factor(lv, gd, cost, x, spec, analytic)
    C = E = gl = None
    if L:
        lv, gd, cost, C, E, gl = _hitl_border(lv, gd, cost, x, graph, n, L)
    return BandedSystem(diag=lv[0], band=lv[1:], g=gd, C=C, E=E,
                        gl=gl), cost


def assemble_banded_system(x, graph: FactorGraph, layout: BandLayout,
                           analytic="moments", lr: OdomFactors = None):
    """Normal equations in block-band(+border) form: (BandedSystem, cost).

    x is [N + L, 3] with L HITL line poses after the N nodes.  Every
    odometry / in-band loop-closure factor must satisfy |i - j| <= layout.w;
    long-range loop closures go in through ``lr`` as Woodbury columns; the
    line poses enter as the border C, E, gl.  A graph whose odometry batch
    reaches past the band (Solver.build_graph without exclude_long_range on
    a map with long-range closures) raises ValueError: its block has no
    slot in the band.
    """
    _refuse_out_of_band(graph.odom.span, layout.w)
    n = layout.n
    L = x.shape[0] - n
    diag, band, gd, cost = _accumulate_banded(x, graph, layout, analytic)
    lv = torch.cat([diag[None], band])
    lv, gd, cost = _scatter_band_factor(lv, gd, cost, x,
                                        odom_factor_spec(graph))
    U = None
    if lr is not None and lr.count:
        U, g_lr, cost_lr = lowrank_factor_columns(x, lr, n)
        gd = gd + g_lr
        cost = cost + cost_lr
    C = E = gl = None
    if L:
        lv, gd, cost, C, E, gl = _hitl_border(lv, gd, cost, x, graph, n, L)
    return BandedSystem(diag=lv[0], band=lv[1:], g=gd, U=U, C=C, E=E,
                        gl=gl), cost


def _accumulate_two_pose(H, g, term):
    """Scatter-add one linearized factor batch into dense H [3M, 3M] and
    g [3M], in place.  The sum order of colliding blocks is the device's,
    so H repeats only to rounding on a card."""
    r, J, dof = term
    Hq, gq = _jtj(r, J)
    H.index_put_((dof[:, :, None], dof[:, None, :]), Hq, accumulate=True)
    g.index_put_((dof,), gq, accumulate=True)


def assemble_normal_equations(x, graph: FactorGraph,
                              layout: BandLayout = None, analytic=True):
    """Dense Gauss-Newton normal equations: (H [3M, 3M], g [3M], cost) for
    x [M, 3], any factor topology.

    With ``layout`` (the delta-major pair order of correspond.make_pairs)
    the planar/edge blocks, the bulk of the factors, accumulate into the
    block band by slice adds and expand to dense H in one reshape, and
    only odometry and HITL factors scatter; without one every batch goes
    through the scatter.  ``analytic`` picks the correspondence blocks'
    form on the layout path, as in assemble_banded_system."""
    n_dof = 3 * x.shape[0]
    H = torch.zeros((n_dof, n_dof), dtype=x.dtype, device=x.device)
    g = torch.zeros((n_dof,), dtype=x.dtype, device=x.device)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    if layout is None or layout.w < 1:
        specs = graph_factor_specs(graph)
    else:
        hitl = hitl_factor_spec(graph)
        specs = [odom_factor_spec(graph)] + ([] if hitl is None else [hitl])
        diag, band, gd, cost = _accumulate_banded(x, graph, layout, analytic)
        n3 = 3 * layout.n
        H[:n3, :n3] += _band_to_dense(diag, band, layout)
        g[:n3] += gd.reshape(n3)
    for spec in specs:
        term = linearize_two_pose(x, *spec)
        if term is not None:
            _accumulate_two_pose(H, g, term)
            cost = cost + 0.5 * torch.sum(term[0] * term[0])
    return H, g, cost


def _band_to_dense(diag, band, layout: BandLayout):
    """Expand the block band to a dense symmetric [3n, 3n] H."""
    n, w = layout.n, layout.w
    S = torch.stack([band[d] for d in reversed(range(w))] + [0.5 * diag],
                    dim=1)                                   # [n, w+1, 3, 3]
    S = torch.nn.functional.pad(S, (0, 0, 0, 0, 0, n - w))   # [n, n+1, 3, 3]
    flat = S.reshape(n * (n + 1), 3, 3)
    D = flat[w:w + n * n].reshape(n, n, 3, 3)
    Dh = D.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
    return Dh + Dh.T
