"""Correlative scan matching (CSM), the stage-major and pair-major engines
(port of nautilus_tpu/kernels/csm.py: CSMParams, build_tables,
_match_chunk_sm, _search_stage, csm_match_to_tables, csm_match,
csm_match_batch, csm_match_pairs, csm_match_grouped).

For each (source, target) pair:

1. coarse: the target cloud is rastered into a smeared log-occupancy table
   (low_res cells over the scan extent plus the +-trans_range window); the
   source cloud is rotated over the +-rotation_restriction window and every
   (rotation, translation) cell is scored.  The stage engine does that in
   the fused coarse kernel (kernels/csm_coarse.py); the pair engine rasters
   each rotation and correlates the rasters with the table
   (kernels/csm_correlate.py).  Both are hand-written CUDA kernels on the
   card;
2. fine: two refinement stages around the coarse optimum score the
   Gaussian-smeared occupancy directly against each source point's K
   nearest target points (no high-resolution raster).

Scores are mean log-occupancy per valid source point.  Pairs are processed
in chunks to bound the fine stages' [C, Rf, W, P, K] intermediates.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nautilus_tpu_torch.kernels.csm_coarse import fused_coarse
from nautilus_tpu_torch.kernels.csm_correlate import correlate

# Pairs per chunk of the stage engine: the leading dim C of every fused
# coarse kernel launch on the auto-LC path.
PAIR_CHUNK = 64
# Pairs per batch of the pair engine: the leading dim B of every correlation
# kernel launch.  Its rasters take 50 MB per pair at the reference params.
PAIR_BATCH = 16


class CSMParams(NamedTuple):
    """Defaults mirror the reference matcher's constructor."""

    scan_range: float = 30.0       # max scan extent from sensor
    trans_range: float = 2.0       # +- translation search window
    low_res: float = 0.3
    high_res: float = 0.01
    sigma: float = 0.06            # Gaussian smear of the lookup table
    rotation_restriction: float = math.pi / 2   # +- rotation window
    fine_k: int = 32               # nearest targets per source point
    # Coarse table precision.  False (default) rounds the coarse table
    # through bfloat16 before scoring, which reproduces the JAX product's
    # bf16 operand storage (raster counts are exact in bf16 up to 256 per
    # cell); True scores against the float32 table.
    coarse_f32: bool = False

    @property
    def table_halfwidth(self) -> float:
        return self.scan_range + self.trans_range

    def kernel_cells(self, res: float) -> int:
        return int(round(2 * self.scan_range / res))

    def offset_cells(self, res: float) -> int:
        return int(round(self.trans_range / res))

    def table_cells(self, res: float) -> int:
        return self.kernel_cells(res) + 2 * self.offset_cells(res)


def wrap_angle(a):
    """Wrap to (-pi, pi] (host arrays)."""
    return np.arctan2(np.sin(a), np.cos(a))


def _rotate(points, theta):
    """points [..., P, 2] rotated by theta [...]."""
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _raster(points, mask, halfwidth: float, res: float, cells: int):
    """Point counts per cell [C, cells, cells] (row = y, col = x) of
    points [C, P, 2] under mask [C, P]."""
    # Divide by a device tensor: CUDA turns division by a CPU scalar into a
    # multiply by the reciprocal, which bins edge points differently.
    res_t = torch.tensor(res, dtype=points.dtype, device=points.device)
    ij = torch.floor((points + halfwidth) / res_t)
    ix, iy = ij[..., 0], ij[..., 1]
    inside = mask & (ix >= 0) & (ix < cells) & (iy >= 0) & (iy < cells)
    flat = torch.where(inside, iy * cells + ix, torch.zeros_like(ix)).long()
    counts = torch.zeros((points.shape[0], cells * cells), dtype=points.dtype,
                         device=points.device)
    counts.scatter_add_(1, flat, inside.to(points.dtype))
    return counts.reshape(-1, cells, cells)


def _smear_log_table(raster, res: float, sigma: float):
    """Separable Gaussian blur of occupancy [C, T, T] -> log table.

    Two shifted-sum passes (rows, then columns) in float32: no convolution
    library, so no TF32 on the card."""
    radius = max(int(round(3 * sigma / res)), 1)
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=raster.device) * res
    kern = torch.exp(-0.5 * (xs / sigma) ** 2)
    t = raster.shape[-1]
    img = torch.nn.functional.pad(raster, (0, 0, radius, radius))
    acc = kern[0] * img[:, 0:t, :]
    for k in range(1, 2 * radius + 1):
        acc = acc + kern[k] * img[:, k:k + t, :]
    img = torch.nn.functional.pad(acc, (radius, radius, 0, 0))
    acc = kern[0] * img[:, :, 0:t]
    for k in range(1, 2 * radius + 1):
        acc = acc + kern[k] * img[:, :, k:k + t]
    return torch.log(torch.clamp(acc, 0.0, 1.0) + 1e-6)


def build_tables(cloud_b, mask_b, params: CSMParams = CSMParams()):
    """Per-target matcher state for clouds [C, P, 2]: the coarse log table
    [C, T, T] and the cloud with masked points parked at 1e3 (their
    Gaussian contribution underflows to exactly 0).  A float64 problem's
    clouds are cast: scan matching runs in float32."""
    cloud_b = cloud_b.float()
    res = params.low_res
    table_lo = _smear_log_table(
        _raster(cloud_b, mask_b, params.table_halfwidth, res,
                params.table_cells(res)),
        res, max(params.sigma, res * 0.5))
    parked = torch.where(mask_b[..., None], cloud_b,
                         torch.full_like(cloud_b, 1e3))
    return table_lo, parked


def _fine_rot_count(prev_rot_step, rot_step, cap=33):
    """Odd rotation count covering +- half the previous stage's spacing."""
    need = 2 * int(np.ceil(prev_rot_step / (2.0 * rot_step))) + 1
    return min(max(need, 3), cap)


def _stage_resolutions(params: CSMParams):
    mid_res = max(params.high_res * 5.0, params.high_res)
    return [params.low_res, mid_res, params.high_res]


def _nearest_targets(aligned_src, tgt_points, k: int):
    """[C, P, K, 2] nearest target points per coarse-aligned source point."""
    d2 = torch.sum((aligned_src[:, :, None, :] - tgt_points[:, None, :, :])
                   ** 2, dim=-1)                                  # [C, P, Q]
    idx = torch.topk(-d2, k, dim=-1).indices                      # [C, P, K]
    c = torch.arange(tgt_points.shape[0], device=tgt_points.device)
    return tgt_points[c[:, None, None], idx]


def _refine_direct(src_points, src_mask, neighbors, thetas, res: float,
                   offset_cells: int, tx0, ty0, sigma: float):
    """One fine stage scored against per-point neighbour targets.

    occ(p) = clip(sum_k exp(-||R(theta) p + t - q_pk||^2 / 2 sigma^2), 1);
    the squared distance is separable, so the (ty x tx) window is one
    contraction over the neighbours.  thetas [C, Rf]; tx0, ty0 [C].
    Returns (scores [C, Rf, W, W], (ty [C, W], tx [C, W])).
    """
    win = 2 * offset_cells + 1
    inv = 1.0 / (2.0 * sigma * sigma)
    steps = (torch.arange(win, device=thetas.device) - offset_cells).to(
        torch.float32) * res
    ty = ty0[:, None] + steps                                     # [C, W]
    tx = tx0[:, None] + steps
    rot = _rotate(src_points[:, None], thetas)                    # [C, R, P, 2]
    dx = rot[..., 0, None] - neighbors[:, None, ..., 0]           # [C, R, P, K]
    dy = rot[..., 1, None] - neighbors[:, None, ..., 1]
    ex = torch.exp(-(dx[:, :, None] + tx[:, None, :, None, None]) ** 2 * inv)
    ey = torch.exp(-(dy[:, :, None] + ty[:, None, :, None, None]) ** 2 * inv)
    occ = torch.einsum("crwpk,crvpk->crwvp", ey, ex)              # [C,R,Wy,Wx,P]
    vals = torch.log(torch.clamp(occ, 0.0, 1.0) + 1e-6)
    vals = torch.where(src_mask[:, None, None, None, :], vals,
                       torch.zeros_like(vals))
    return torch.sum(vals, dim=-1), (ty, tx)


def _argmax_flat(scores):
    """First-index argmax over all but the leading dim -> [C] flat index."""
    return torch.argmax(scores.reshape(scores.shape[0], -1), dim=1)


def _n_valid(mask_a):
    return torch.clamp(torch.sum(mask_a.to(torch.float32), dim=1), min=1.0)


def _coarse_table(table_lo, params: CSMParams):
    """The coarse table as the JAX product stores it: rounded through
    bfloat16 unless coarse_f32.  Raster counts need no rounding: they are
    exact in bfloat16 up to 256 per cell, far above what a 0.3 m cell of
    one scan holds."""
    if params.coarse_f32:
        return table_lo.contiguous()
    return table_lo.to(torch.bfloat16).to(torch.float32).contiguous()


def _coarse_rot_count(params: CSMParams) -> int:
    """Coarse rotations: one step moves the farthest point one cell."""
    rot_step_lo = params.low_res / params.scan_range
    return max(int(np.ceil(2 * params.rotation_restriction / rot_step_lo)), 1)


def _coarse_optimum(scores, thetas, params: CSMParams):
    """(theta0, tx0, ty0) [C] at the first-index argmax of the coarse scores
    [C, R, noff, noff] over (rotation, oy, ox)."""
    C, _, noff, _ = scores.shape
    res = params.low_res
    offset_lo = params.offset_cells(res)
    k = _argmax_flat(scores)
    r0 = k // (noff * noff)
    oy0 = (k % (noff * noff)) // noff
    ox0 = k % noff
    theta0 = thetas[torch.arange(C, device=scores.device), r0]
    ty0 = (oy0 - offset_lo).to(torch.float32) * res
    tx0 = (ox0 - offset_lo).to(torch.float32) * res
    return theta0, tx0, ty0


def _match_chunk_sm(cloud_a, mask_a, cloud_b, mask_b, centers,
                    params: CSMParams):
    """Stage-major matching of one pair chunk (leading dim C).
    Returns (scores [C], transforms [C, 3])."""
    dev = cloud_a.device
    n_valid = _n_valid(mask_a)
    table_lo, tgt_points = build_tables(cloud_b, mask_b, params)
    table_lo = _coarse_table(table_lo, params)

    res = params.low_res
    cells = params.kernel_cells(res)
    noff = 2 * params.offset_cells(res) + 1
    n_rot = _coarse_rot_count(params)
    base = (-params.rotation_restriction
            + (torch.arange(n_rot, device=dev, dtype=torch.float32) + 0.5)
            * (2 * params.rotation_restriction / n_rot))
    thetas = (centers[:, None] + base[None, :]).contiguous()     # [C, n_rot]
    parked = torch.where(mask_a[..., None], cloud_a,
                         torch.full_like(cloud_a, 1e6)).contiguous()
    scores = fused_coarse(parked, thetas, table_lo, cells=cells,
                          noff=noff, halfwidth=params.scan_range, res=res)
    theta0, tx0, ty0 = _coarse_optimum(scores, thetas, params)
    return _refine_pyramid(cloud_a, mask_a, tgt_points, theta0, tx0, ty0,
                           n_valid, params)


def _refine_pyramid(cloud_a, mask_a, tgt_points, theta0, tx0, ty0, n_valid,
                    params: CSMParams):
    """The two fine stages around the coarse optimum (theta0, tx0, ty0
    [C]), scored against the K nearest target points of each coarse-aligned
    source point.  Returns (scores [C], transforms [C, 3])."""
    C = cloud_a.shape[0]
    dev = cloud_a.device
    idx = torch.arange(C, device=dev)
    _, mid_res, _ = _stage_resolutions(params)
    aligned = _rotate(cloud_a, theta0) + torch.stack([tx0, ty0], dim=-1)[:, None]
    neighbors = _nearest_targets(aligned, tgt_points, params.fine_k)
    rot_step_lo = params.low_res / params.scan_range
    stages = [
        (mid_res, mid_res / params.scan_range, params.low_res, rot_step_lo),
        (params.high_res, params.high_res / params.scan_range,
         mid_res, mid_res / params.scan_range),
    ]
    theta, tx, ty = theta0, tx0, ty0
    for res_s, rot_step, prev_res, prev_rot_step in stages:
        n_rot_f = _fine_rot_count(prev_rot_step, rot_step)
        th = theta[:, None] + ((torch.arange(n_rot_f, device=dev)
                                - n_rot_f // 2) * rot_step)[None, :]
        offs = int(round(prev_res / res_s))
        fine, (ty_grid, tx_grid) = _refine_direct(
            cloud_a, mask_a, neighbors, th, res_s, offs, tx, ty, params.sigma)
        win = 2 * offs + 1
        k = _argmax_flat(fine)
        r1, oy1, ox1 = k // (win * win), (k % (win * win)) // win, k % win
        theta = th[idx, r1]
        ty = ty_grid[idx, oy1]
        tx = tx_grid[idx, ox1]
        best = fine[idx, r1, oy1, ox1]
    return best / n_valid, torch.stack([tx, ty, theta], dim=-1)


# ---------------------------------------------------------------------------
# Pair-major engine: the reference matcher's GetTransformation contract for
# one pair at a time (csm_match), written out over a batch of pairs.  Its
# coarse stage rasters every rotation of the source scan explicitly and
# correlates the rasters with the pair's table (kernels/csm_correlate.py,
# a hand-written CUDA kernel on the card).
# ---------------------------------------------------------------------------

def _search_stage(table_log, src_points, src_mask, thetas, res: float,
                  scan_range: float):
    """Score the full (rotation x translation) grid at one resolution.

    table_log [B, T, T] spans [-hw, hw] with hw = scan_range + trans_range,
    the source rasters [-scan_range, scan_range]; src_points [B, P, 2],
    src_mask [B, P], thetas [B, R].  A VALID correlation gives offsets o in
    [0, 2 trans_range / res], i.e. translation o * res - trans_range.
    Returns scores [B, R, OT, OT]."""
    cells = int(round(2 * scan_range / res))
    B, P, _ = src_points.shape
    R = thetas.shape[1]
    rot = _rotate(src_points[:, None], thetas)                    # [B, R, P, 2]
    mask = src_mask[:, None].expand(B, R, P).reshape(B * R, P)
    rasters = _raster(rot.reshape(B * R, P, 2), mask, scan_range, res, cells)
    return correlate(table_log, rasters.reshape(B, R, cells, cells))


def _match_to_tables_batch(table_lo, tgt_points, cloud_a, mask_a, centers,
                           params: CSMParams):
    """Pair-major matching of a batch of pairs against prebuilt tables
    (table_lo [B, T, T], tgt_points [B, Q, 2]).  Returns (scores [B],
    transforms [B, 3])."""
    res = params.low_res
    rr = params.rotation_restriction
    n_rot = _coarse_rot_count(params)
    thetas = ((centers[:, None] - rr)
              + (torch.arange(n_rot, device=cloud_a.device,
                              dtype=torch.float32) + 0.5)
              * (2 * rr / n_rot)).contiguous()                   # [B, n_rot]
    scores = _search_stage(_coarse_table(table_lo, params), cloud_a, mask_a,
                           thetas, res, params.scan_range)
    theta0, tx0, ty0 = _coarse_optimum(scores, thetas, params)
    return _refine_pyramid(cloud_a, mask_a, tgt_points, theta0, tx0, ty0,
                           _n_valid(mask_a), params)


def csm_match_to_tables(tables, cloud_a, mask_a,
                        params: CSMParams = CSMParams(),
                        rotation_center: float = 0.0):
    """Match one source cloud [P, 2] (mask [P]) against one target's tables
    (table_lo [T, T], parked target points [Q, 2]).  rotation_center seeds
    the +-rotation_restriction search window (the solution-implied relative
    heading).  Returns (score 0-dim, [tx, ty, theta])."""
    table_lo, tgt_points = tables
    cloud_a = cloud_a.float()
    centers = torch.full((1,), float(rotation_center), dtype=torch.float32,
                         device=cloud_a.device)
    s, tr = _match_to_tables_batch(table_lo[None], tgt_points[None],
                                   cloud_a[None], mask_a[None], centers,
                                   params)
    return s[0], tr[0]


def csm_match(cloud_a, mask_a, cloud_b, mask_b,
              params: CSMParams = CSMParams(), rotation_center: float = 0.0):
    """Find the rigid transform aligning cloud_a [P, 2] onto cloud_b.

    Returns (score, [tx, ty, theta]): R(theta) then the translation overlays
    cloud_a on cloud_b (both in sensor frames), the contract of the
    reference's GetTransformation.  theta is absolute, not relative to
    rotation_center.  Score is mean log-occupancy per valid source point
    (higher is better)."""
    table_lo, parked = build_tables(cloud_b[None], mask_b[None], params)
    return csm_match_to_tables((table_lo[0], parked[0]), cloud_a, mask_a,
                               params, rotation_center)


def csm_match_batch(clouds_a, masks_a, clouds_b, masks_b,
                    params: CSMParams = CSMParams(),
                    inner_batch: int = PAIR_BATCH, rotation_centers=None):
    """csm_match over pairs [Q, P, 2] (masks [Q, P]), ``inner_batch`` pairs
    per coarse kernel launch.  rotation_centers: optional [Q] tensor.
    Returns (scores [Q], transforms [Q, 3]) tensors."""
    q = clouds_a.shape[0]
    dev = clouds_a.device
    # Scan matching runs in float32 whatever the solver's dtype.
    clouds_a = clouds_a.float()
    if rotation_centers is None:
        rotation_centers = torch.zeros(q, dtype=torch.float32, device=dev)
    scores, transforms = [], []
    for c0 in range(0, q, inner_batch):
        sl = slice(c0, c0 + inner_batch)
        table_lo, tgt_points = build_tables(clouds_b[sl], masks_b[sl], params)
        s, tr = _match_to_tables_batch(table_lo, tgt_points, clouds_a[sl],
                                       masks_a[sl], rotation_centers[sl],
                                       params)
        scores.append(s)
        transforms.append(tr)
    if not scores:
        return (torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.float32, device=dev))
    return torch.cat(scores), torch.cat(transforms)


def csm_match_pairs(points, masks, src_idx, tgt_idx,
                    params: CSMParams = CSMParams(), rotation_centers=None,
                    engine: str = "stage", pair_chunk: Optional[int] = None):
    """Match an arbitrary (source, target) pair list.

    engine: "stage" (default, the auto-LC path) runs the stage-major engine,
    PAIR_CHUNK pairs per fused coarse kernel launch; "pair" runs the
    pair-major engine (csm_match_batch), PAIR_BATCH pairs per correlation
    kernel launch.  pair_chunk overrides either count.

    points [N, P, 2] / masks [N, P] tensors on the matching device; src_idx,
    tgt_idx host int arrays; rotation_centers: optional [Q] per-pair
    rotation-search centres (solution-implied relative headings).
    Returns host arrays (scores [Q] float32, transforms [Q, 3] float32);
    a transform maps source points into the target frame:
    p_t = R(theta) p_s + [tx, ty].
    """
    if engine not in ("stage", "pair"):
        raise ValueError(f"engine must be 'stage' or 'pair', got {engine!r}")
    src_idx = np.asarray(src_idx, np.int64)
    tgt_idx = np.asarray(tgt_idx, np.int64)
    q = len(src_idx)
    if q == 0:
        return np.zeros(0, np.float32), np.zeros((0, 3), np.float32)
    if rotation_centers is None:
        rotation_centers = np.zeros(q, np.float32)
    dev = points.device
    # Scan matching runs in float32 whatever the solver's dtype: a float64
    # problem's clouds hold float32 values, so the cast is exact.
    points = points.float()
    centers = torch.as_tensor(np.asarray(rotation_centers, np.float32),
                              device=dev)
    ss = torch.as_tensor(src_idx, device=dev)
    tt = torch.as_tensor(tgt_idx, device=dev)
    if engine == "pair":
        scores, transforms = csm_match_batch(
            points[ss], masks[ss], points[tt], masks[tt], params,
            inner_batch=pair_chunk or PAIR_BATCH, rotation_centers=centers)
        return (scores.cpu().numpy().astype(np.float32),
                transforms.cpu().numpy().astype(np.float32))
    pair_chunk = pair_chunk or PAIR_CHUNK
    scores, transforms = [], []
    for c0 in range(0, q, pair_chunk):
        sl = slice(c0, c0 + pair_chunk)
        s, tr = _match_chunk_sm(points[ss[sl]], masks[ss[sl]],
                                points[tt[sl]], masks[tt[sl]], centers[sl],
                                params)
        scores.append(s)
        transforms.append(tr)
    return (torch.cat(scores).cpu().numpy().astype(np.float32),
            torch.cat(transforms).cpu().numpy().astype(np.float32))


def csm_match_grouped(points, masks, src_idx, tgt_idx,
                      params: CSMParams = CSMParams()):
    """Match a (source, target) pair list grouped by target: one table
    build per unique target, then the pair engine over that target's
    sources, PAIR_BATCH per correlation kernel launch.  Rotation searches
    are centred on 0.

    points [N, P, 2] / masks [N, P] tensors; src_idx, tgt_idx host int
    arrays.  Returns host arrays (scores [Q] float32, transforms [Q, 3]
    float32) in the input's pair order."""
    src_idx = np.asarray(src_idx, np.int64)
    tgt_idx = np.asarray(tgt_idx, np.int64)
    q = len(src_idx)
    scores = np.zeros(q, np.float32)
    transforms = np.zeros((q, 3), np.float32)
    dev = points.device
    points = points.float()
    for t in np.unique(tgt_idx):
        rows = np.nonzero(tgt_idx == t)[0]
        table_lo, tgt_points = build_tables(points[int(t)][None],
                                            masks[int(t)][None], params)
        for c0 in range(0, len(rows), PAIR_BATCH):
            part = rows[c0:c0 + PAIR_BATCH]
            b = len(part)
            ss = torch.as_tensor(src_idx[part], device=dev)
            s, tr = _match_to_tables_batch(
                table_lo.expand(b, -1, -1), tgt_points.expand(b, -1, -1),
                points[ss], masks[ss],
                torch.zeros(b, dtype=torch.float32, device=dev), params)
            scores[part] = s.cpu().numpy()
            transforms[part] = tr.cpu().numpy()
    return scores, transforms
