"""Correlative scan matching (CSM), stage-major batch engine (port of
nautilus_tpu/kernels/csm.py: CSMParams, build_tables, _match_chunk_sm,
csm_match_pairs).

For each (source, target) pair:

1. coarse: the target cloud is rastered into a smeared log-occupancy table
   (low_res cells over the scan extent plus the +-trans_range window); the
   source cloud is rotated over the +-rotation_restriction window and every
   (rotation, translation) cell is scored by the fused coarse kernel
   (kernels/csm_coarse.py, a hand-written CUDA kernel on the card);
2. fine: two refinement stages around the coarse optimum score the
   Gaussian-smeared occupancy directly against each source point's K
   nearest target points (no high-resolution raster).

Scores are mean log-occupancy per valid source point.  Pairs are processed
in chunks to bound the fine stages' [C, Rf, W, P, K] intermediates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nautilus_tpu_torch.kernels.csm_coarse import fused_coarse

# Pairs per chunk of csm_match_pairs: the leading dim C of every coarse
# kernel launch on the auto-LC path.
PAIR_CHUNK = 64


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
    Gaussian contribution underflows to exactly 0)."""
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


def _match_chunk_sm(cloud_a, mask_a, cloud_b, mask_b, centers,
                    params: CSMParams):
    """Stage-major matching of one pair chunk (leading dim C).
    Returns (scores [C], transforms [C, 3])."""
    C = cloud_a.shape[0]
    dev = cloud_a.device
    n_valid = torch.clamp(torch.sum(mask_a.to(torch.float32), dim=1), min=1.0)
    table_lo, tgt_points = build_tables(cloud_b, mask_b, params)

    res = params.low_res
    cells = params.kernel_cells(res)
    offset_lo = params.offset_cells(res)
    noff = 2 * offset_lo + 1
    if not params.coarse_f32:
        table_lo = table_lo.to(torch.bfloat16).to(torch.float32)

    rot_step_lo = res / params.scan_range
    n_rot = max(int(np.ceil(2 * params.rotation_restriction / rot_step_lo)),
                1)
    base = (-params.rotation_restriction
            + (torch.arange(n_rot, device=dev, dtype=torch.float32) + 0.5)
            * (2 * params.rotation_restriction / n_rot))
    thetas = (centers[:, None] + base[None, :]).contiguous()     # [C, n_rot]
    parked = torch.where(mask_a[..., None], cloud_a,
                         torch.full_like(cloud_a, 1e6)).contiguous()
    scores = fused_coarse(parked, thetas, table_lo.contiguous(), cells=cells,
                          noff=noff, halfwidth=params.scan_range, res=res)
    k = _argmax_flat(scores)                       # over (rotation, oy, ox)
    idx = torch.arange(C, device=dev)
    r0 = k // (noff * noff)
    oy0 = (k % (noff * noff)) // noff
    ox0 = k % noff
    theta0 = thetas[idx, r0]
    ty0 = (oy0 - offset_lo).to(torch.float32) * res
    tx0 = (ox0 - offset_lo).to(torch.float32) * res

    _, mid_res, _ = _stage_resolutions(params)
    aligned = _rotate(cloud_a, theta0) + torch.stack([tx0, ty0], dim=-1)[:, None]
    neighbors = _nearest_targets(aligned, tgt_points, params.fine_k)
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


def csm_match_pairs(points, masks, src_idx, tgt_idx,
                    params: CSMParams = CSMParams(), rotation_centers=None,
                    pair_chunk: int = PAIR_CHUNK):
    """Match an arbitrary (source, target) pair list.

    points [N, P, 2] / masks [N, P] tensors on the matching device; src_idx,
    tgt_idx host int arrays; rotation_centers: optional [Q] per-pair
    rotation-search centres (solution-implied relative headings).
    Returns host arrays (scores [Q] float32, transforms [Q, 3] float32);
    a transform maps source points into the target frame:
    p_t = R(theta) p_s + [tx, ty].
    """
    src_idx = np.asarray(src_idx, np.int64)
    tgt_idx = np.asarray(tgt_idx, np.int64)
    q = len(src_idx)
    if q == 0:
        return np.zeros(0, np.float32), np.zeros((0, 3), np.float32)
    if rotation_centers is None:
        rotation_centers = np.zeros(q, np.float32)
    dev = points.device
    centers = torch.as_tensor(np.asarray(rotation_centers, np.float32),
                              device=dev)
    ss = torch.as_tensor(src_idx, device=dev)
    tt = torch.as_tensor(tgt_idx, device=dev)
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
