"""CPU twin of the correlative scan matcher (numpy/scipy, float32); port
of nautilus_tpu/baseline/cpu_csm.py.

The scan-match counterpart of baseline/cpu_reference.py: the same
multi-resolution correlative matching algorithm as kernels/csm.py — coarse
(rotation x translation) grid scored against a Gaussian-smeared
log-occupancy table, then a direct-Gaussian refinement pyramid — written
as an optimized CPU program (vectorized numpy; BLAS matmul for the
correlation, cKDTree for neighbor selection).  It scores in float32 against
the float32 coarse table (the port's engines round that table through
bfloat16 unless ``CSMParams.coarse_f32``), with none of the port's torch
code or CUDA kernels, so it holds both engines (stage: the fused coarse
kernel; pair: the correlation kernel) to an independent computation
(tests/test_torch_cpu_csm.py; chip_smoke.py phase 17).

The reference's own matcher (third_party CorrelativeScanMatcher,
constructed at solver.cc:56) is plain C++ loops over the same
multi-resolution search; vectorized numpy + BLAS is a generous stand-in.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree

from nautilus_tpu_torch.kernels.csm import CSMParams, _fine_rot_count


def _raster(points, halfwidth, res, cells):
    ij = np.floor((points + halfwidth) / res).astype(np.int64)
    ok = np.all((ij >= 0) & (ij < cells), axis=-1)
    img = np.zeros((cells, cells), np.float32)
    np.add.at(img, (ij[ok, 1], ij[ok, 0]), 1.0)
    return img


def _smear_log_table(raster, res, sigma):
    radius = max(int(round(3 * sigma / res)), 1)
    xs = np.arange(-radius, radius + 1, dtype=np.float32) * res
    kern = np.exp(-0.5 * (xs / sigma) ** 2)
    # Separable blur with zero padding (matches the port's table smear).
    pad = np.pad(raster, ((radius, radius), (0, 0)))
    img = np.einsum("k,kij->ij", kern,
                    np.stack([pad[i:i + raster.shape[0]]
                              for i in range(2 * radius + 1)]))
    pad = np.pad(img, ((0, 0), (radius, radius)))
    img = np.einsum("k,kij->ij", kern,
                    np.stack([pad[:, i:i + raster.shape[1]]
                              for i in range(2 * radius + 1)]))
    occ = np.clip(img, 0.0, 1.0)
    return np.log(occ + 1e-6)


def _rotate(points, theta):
    c, s = np.cos(theta), np.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return np.stack([c * x - s * y, s * x + c * y], axis=-1)


def _correlate_matmul(table, kernels):
    """scores[r, oy, ox] via im2col + one BLAS matmul (the contract of the
    correlation kernel, kernels/csm_correlate.correlate)."""
    r, kh, kw = kernels.shape
    oh = table.shape[0] - kh + 1
    ow = table.shape[1] - kw + 1
    patches = np.stack(
        [table[oy:oy + kh, ox:ox + kw].reshape(-1)
         for oy in range(oh) for ox in range(ow)], axis=1)
    scores = kernels.reshape(r, -1) @ patches
    return scores.reshape(r, oh, ow)


def _stage_resolutions(params: CSMParams):
    mid_res = max(params.high_res * 5.0, params.high_res)
    return [params.low_res, mid_res, params.high_res]


def _refine_direct(src_points, neighbors, thetas, res, offset_cells,
                   tx0, ty0, sigma):
    win = 2 * offset_cells + 1
    inv = 1.0 / (2.0 * sigma * sigma)
    steps = (np.arange(win) - offset_cells).astype(np.float32) * res
    ty = ty0 + steps
    tx = tx0 + steps
    rot = np.stack([_rotate(src_points, t) for t in thetas])   # [R, P, 2]
    dx = rot[..., 0, None] - neighbors[None, ..., 0]           # [R, P, K]
    dy = rot[..., 1, None] - neighbors[None, ..., 1]
    ex = np.exp(-(dx[:, None] + tx[None, :, None, None]) ** 2 * inv)
    ey = np.exp(-(dy[:, None] + ty[None, :, None, None]) ** 2 * inv)
    occ = np.einsum("rwpk,rvpk->rwvp", ey, ex)                 # [R,Wy,Wx,P]
    vals = np.log(np.clip(occ, 0.0, 1.0) + 1e-6)
    return np.sum(vals, axis=-1), (ty, tx)


def csm_match_cpu(cloud_a, cloud_b, params: CSMParams = CSMParams(),
                  rotation_center: float = 0.0):
    """(score, [tx, ty, theta]) for unpadded clouds [P, 2] / [Q, 2]."""
    cloud_a = np.asarray(cloud_a, np.float32)
    cloud_b = np.asarray(cloud_b, np.float32)
    n_valid = max(len(cloud_a), 1)
    halfwidth = params.table_halfwidth
    res = params.low_res
    table_lo = _smear_log_table(
        _raster(cloud_b, halfwidth, res, params.table_cells(res)),
        res, max(params.sigma, res * 0.5))

    rot_step_lo = params.low_res / params.scan_range
    n_rot = max(int(math.ceil(2 * params.rotation_restriction / rot_step_lo)),
                1)
    thetas_lo = (rotation_center - params.rotation_restriction
                 + (np.arange(n_rot) + 0.5)
                 * (2 * params.rotation_restriction / n_rot))
    cells_k = params.kernel_cells(res)
    rasters = np.stack([_raster(_rotate(cloud_a, t), params.scan_range,
                                res, cells_k) for t in thetas_lo])
    scores_lo = _correlate_matmul(table_lo, rasters)
    r0, oy0, ox0 = np.unravel_index(np.argmax(scores_lo), scores_lo.shape)
    offset_lo = params.offset_cells(res)
    theta = float(thetas_lo[r0])
    ty = float((oy0 - offset_lo) * res)
    tx = float((ox0 - offset_lo) * res)
    best = float(scores_lo[r0, oy0, ox0])

    # Refinement pyramid: K nearest target points per coarse-aligned source
    # point, shared across stages (same structure as the port's engines).
    _, mid_res, _ = _stage_resolutions(params)
    aligned = _rotate(cloud_a, theta) + np.array([tx, ty], np.float32)
    k = min(params.fine_k, len(cloud_b)) or 1
    if len(cloud_b):
        _, idx = cKDTree(cloud_b).query(aligned, k=k)
        neighbors = cloud_b[np.atleast_2d(idx.T).T.reshape(len(cloud_a), k)]
    else:
        neighbors = np.full((len(cloud_a), 1, 2), 1e3, np.float32)
    rot_step_lo = params.low_res / params.scan_range
    stages = [
        (mid_res, mid_res / params.scan_range, params.low_res, rot_step_lo),
        (params.high_res, params.high_res / params.scan_range,
         mid_res, mid_res / params.scan_range),
    ]
    for res_s, rot_step, prev_res, prev_rot_step in stages:
        # Shared with the port's engines so the twins cannot drift.
        n_rot = _fine_rot_count(prev_rot_step, rot_step)
        thetas = theta + (np.arange(n_rot) - n_rot // 2) * rot_step
        offset_cells = int(round(prev_res / res_s))
        scores, t_grid = _refine_direct(cloud_a, neighbors, thetas, res_s,
                                        offset_cells, tx, ty, params.sigma)
        r1, oy1, ox1 = np.unravel_index(np.argmax(scores), scores.shape)
        theta = float(thetas[r1])
        ty = float(t_grid[0][oy1])
        tx = float(t_grid[1][ox1])
        best = float(scores[r1, oy1, ox1])
    return best / n_valid, np.array([tx, ty, theta], np.float32)


def csm_match_batch_cpu(clouds_a, masks_a, clouds_b, masks_b,
                        params: CSMParams = CSMParams(),
                        rotation_centers=None):
    """Batched CPU matching over padded cloud arrays (numpy, host)."""
    out_s = np.zeros(len(clouds_a), np.float32)
    out_t = np.zeros((len(clouds_a), 3), np.float32)
    if rotation_centers is None:
        rotation_centers = np.zeros(len(clouds_a), np.float32)
    for i in range(len(clouds_a)):
        a = np.asarray(clouds_a[i])[np.asarray(masks_a[i])]
        b = np.asarray(clouds_b[i])[np.asarray(masks_b[i])]
        out_s[i], out_t[i] = csm_match_cpu(a, b, params,
                                           float(rotation_centers[i]))
    return out_s, out_t
