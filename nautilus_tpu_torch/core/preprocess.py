"""Batched per-scan preprocessing: PCA normals + LOAM-style features
(port of nautilus_tpu/core/preprocess.py).

- Normals: for each point, neighbours within the smallest radius of a fixed
  growth schedule that holds >= 2 points; the normal is the minor
  eigenvector of the neighbourhood scatter, canonicalized to the upper
  half-plane.
- Smoothness: lambda_min / lambda_max of an index-window neighbourhood
  (distance-filtered on both sides, >= min_neighbors neighbours).
- Greedy selection: planar = lowest scores at or below the threshold, edge =
  highest at or above it, under a mutual minimum distance and per-type caps.

Scans are processed in chunks with the batch dimension written out; the
greedy selection is a Python loop over the candidate order, batched over
all scans.  Only the PCA normal estimator is ported (the Hough variant is
on the ROADMAP).

Summation order.  Straight walls give many points whose smoothness score
is rounding noise around 0, and the greedy selection sorts those scores:
a different float summation order selects different features.  So the
scatter sums here run in one fixed order (``_sum_fixed``, ``_matmul_fixed``)
— the order the JAX package's CPU backend uses — and give the same bits on
every device, which keeps the feature sets identical to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureParams(NamedTuple):
    """Defaults mirror the reference's hardcoded feature-extractor args."""

    threshold: float = 0.008          # planar below, edge above
    distance_threshold: float = 2.0   # min mutual distance between features
    neighbors_per_side: int = 10      # index-window half-width
    max_edge: int = 10
    max_planar: int = 20
    min_neighbors: int = 10           # min window neighbours for a score


class NormalParams(NamedTuple):
    """Defaults mirror config/default_config.lua nc_* keys."""

    neighborhood_size: float = 0.15
    neighborhood_step: float = 0.1
    num_radius_steps: int = 4
    bin_number: int = 32
    mean_distance: float = 0.1
    k_neighbors: int = 12
    method: str = "pca"


def normal_params_from_config(cfg, method: str = "pca") -> NormalParams:
    """Bind the nc_* Lua keys."""
    return NormalParams(
        neighborhood_size=float(cfg.get("nc_neighborhood_size", 0.15)),
        neighborhood_step=float(cfg.get("nc_neighborhood_step_size", 0.1)),
        bin_number=int(cfg.get("nc_bin_number", 32)),
        mean_distance=float(cfg.get("nc_mean_distance", 0.1)),
        method=method)


def _sum_fixed(x):
    """Sum over the last axis in a fixed order: sequential sums over
    consecutive windows of 32, then the same over the window sums."""
    n = x.shape[-1]
    if n > 32:
        nw = -(-n // 32)
        if nw * 32 != n:
            x = torch.nn.functional.pad(x, (0, nw * 32 - n))
        x = _sum_fixed(x.reshape(x.shape[:-1] + (nw, 32)))
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _matmul_fixed(w, points):
    """w [B, P, K] @ points [B, K, 2] in a fixed order: four interleaved
    partial sums (k mod 4) accumulated sequentially, combined pairwise."""
    b, p, k = w.shape
    if k % 4:
        raise ValueError(f"contraction length {k} must be a multiple of 4")
    w4 = w.reshape(b, p, k // 4, 4, 1)
    p4 = points.reshape(b, 1, k // 4, 4, 2)
    acc = w4[:, :, 0] * p4[:, :, 0]                           # [B, P, 4, 2]
    for j in range(1, k // 4):
        acc = acc + w4[:, :, j] * p4[:, :, j]
    return (acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])


def _fma(a, b, c):
    """a * b + c rounded once, as the reference's CPU code generator fuses
    it (float64 holds the float32 product exactly)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _sqrt(x):
    """Correctly rounded float32 square root on every device."""
    return torch.sqrt(x.double()).to(x.dtype)


def _disc(sxx, sxy, syy):
    """sqrt((sxx - syy)^2 + 4 sxy^2), the scatter eigenvalue gap."""
    d = sxx - syy
    return _sqrt(torch.clamp(_fma(d, d, 4.0 * sxy * sxy), min=0.0))


def _pair_d2(points):
    diff = points[:, :, None, :] - points[:, None, :, :]
    return torch.sum(diff * diff, dim=-1)                    # [B, P, P]


def _scan_normals(points, mask, params: NormalParams):
    """Normals for a chunk of scans: points [B, P, 2], mask [B, P]."""
    dtype = points.dtype
    pair_valid = mask[:, :, None] & mask[:, None, :]
    d2 = torch.where(pair_valid, _pair_d2(points),
                     torch.full((), float("inf"), dtype=dtype,
                                device=points.device))
    steps = params.num_radius_steps
    radii = params.neighborhood_size + params.neighborhood_step * torch.arange(
        steps, dtype=dtype, device=points.device)
    within = d2[:, None] <= (radii[None, :, None, None] ** 2)  # [B, R, P, P]
    counts = torch.sum(within, dim=-1)                         # [B, R, P]
    enough = counts >= 2
    first = torch.argmax(enough.to(torch.uint8), dim=1)        # [B, P]
    radius_idx = torch.where(enough.any(dim=1), first,
                             torch.full_like(first, steps - 1))
    nbr = torch.gather(
        within, 1,
        radius_idx[:, None, :, None].expand(-1, 1, -1, within.shape[-1]))[:, 0]

    w = nbr.to(dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = _matmul_fixed(w, points) / n[..., None]
    centered = points[:, None, :, :] - mean[:, :, None, :]     # [B, P, P, 2]
    cx, cy = centered[..., 0], centered[..., 1]
    sxx = _sum_fixed(w * cx * cx)
    sxy = _sum_fixed(w * cx * cy)
    syy = _sum_fixed(w * cy * cy)
    disc = _disc(sxx, sxy, syy)
    lam_min = 0.5 * (sxx + syy - disc)
    v1 = torch.stack([sxy, lam_min - sxx], dim=-1)
    v2 = torch.stack([lam_min - syy, sxy], dim=-1)
    use_v1 = torch.sum(v1 * v1, dim=-1) >= torch.sum(v2 * v2, dim=-1)
    v = torch.where(use_v1[..., None], v1, v2)
    norm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
    normal = v / norm[..., None]
    # Isotropic scatter: fall back to the +x axis.
    degenerate = disc < 1e-12
    normal = torch.where(degenerate[..., None],
                         torch.tensor([1.0, 0.0], dtype=dtype,
                                      device=points.device), normal)
    # Canonical orientation: upper half-plane (ny > 0, or nx > 0 at ny == 0).
    flip = (normal[..., 1] < 0) | ((normal[..., 1] == 0) & (normal[..., 0] < 0))
    normal = torch.where(flip[..., None], -normal, normal)
    return torch.where(mask[..., None], normal, torch.zeros_like(normal))


def _scan_smoothness(points, mask, params: FeatureParams):
    """Smoothness scores [B, P] and validity [B, P] for a chunk of scans."""
    p = points.shape[1]
    idx = torch.arange(p, device=points.device)
    offset = idx[None, :] - idx[:, None]
    in_window = (torch.abs(offset) <= params.neighbors_per_side) & (offset != 0)
    pair_valid = mask[:, :, None] & mask[:, None, :]
    near = _pair_d2(points) <= params.distance_threshold ** 2
    nbr = in_window[None] & pair_valid & near
    count = torch.sum(nbr, dim=-1)
    valid = (count >= params.min_neighbors) & mask
    # The centre point joins its own scatter.
    eye = torch.eye(p, dtype=torch.bool, device=points.device)
    nbr_self = nbr | (eye[None] & mask[:, :, None])
    w = nbr_self.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = _matmul_fixed(w, points) / n[..., None]
    centered = points[:, None, :, :] - mean[:, :, None, :]
    cx, cy = centered[..., 0], centered[..., 1]
    sxx = _sum_fixed(cx ** 2 * w)
    sxy = _sum_fixed(cx * cy * w)
    syy = _sum_fixed(cy ** 2 * w)
    tr = sxx + syy
    disc = _disc(sxx, sxy, syy)
    lam_max = 0.5 * (tr + disc)
    lam_min = 0.5 * (tr - disc)
    score = lam_min / torch.clamp(lam_max, min=1e-20)
    return torch.clamp(score, 0.0, 1.0), valid


_GREEDY_CANDIDATES = 128  # caps are <= 20 selections, filled long before


def _greedy_select(points, order, ok, max_count: int, dist_threshold: float):
    """Greedy min-distance selection along a candidate order, batched.

    points [N, P, 2]; order [N, P] candidate indices (best first); ok [N, P]
    eligibility.  Returns (sel_idx [N, K], sel_mask [N, K]), K = max_count.
    Only the first _GREEDY_CANDIDATES candidates are visited, as in the JAX
    package.
    """
    n = points.shape[0]
    k = max_count
    dev = points.device
    rows = torch.arange(n, device=dev)
    sel_pts = torch.full((n, k, 2), 1e9, dtype=points.dtype, device=dev)
    sel_idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    count = torch.zeros((n,), dtype=torch.int64, device=dev)
    thr2 = dist_threshold ** 2
    for step in range(min(order.shape[1], _GREEDY_CANDIDATES)):
        cand = order[:, step]
        p = points[rows, cand]                                  # [N, 2]
        d2 = torch.sum((sel_pts - p[:, None, :]) ** 2, dim=-1)  # [N, K]
        clear = torch.amin(d2, dim=-1) >= thr2
        accept = ok[rows, cand] & clear & (count < k)
        slot = torch.where(accept, count, torch.full_like(count, k - 1))
        sel_pts[rows, slot] = torch.where(accept[:, None], p,
                                          sel_pts[rows, slot])
        sel_idx[rows, slot] = torch.where(accept, cand, sel_idx[rows, slot])
        count = count + accept.to(count.dtype)
    sel_mask = torch.arange(k, device=dev)[None, :] < count[:, None]
    sel_idx = torch.where(sel_mask, sel_idx, torch.zeros_like(sel_idx))
    return sel_idx, sel_mask


def extract_features(points, mask, params: FeatureParams = FeatureParams(),
                     chunk: int = 16):
    """points [N, P, 2], mask [N, P] -> (planar_idx [N, PL], planar_mask,
    edge_idx [N, ED], edge_mask, scores [N, P])."""
    parts = [_scan_smoothness(points[i:i + chunk], mask[i:i + chunk], params)
             for i in range(0, points.shape[0], chunk)]
    scores = torch.cat([s for s, _ in parts])
    valid = torch.cat([v for _, v in parts])
    inf = torch.full((), float("inf"), dtype=scores.dtype, device=scores.device)
    # Planar: ascending score at or below the threshold; edge: descending
    # score at or above it.  Stable sorts keep the JAX candidate order.
    asc = torch.argsort(torch.where(valid, scores, inf), dim=1, stable=True)
    planar_idx, planar_mask = _greedy_select(
        points, asc, valid & (scores <= params.threshold), params.max_planar,
        params.distance_threshold)
    desc = torch.argsort(torch.where(valid, -scores, inf), dim=1, stable=True)
    edge_idx, edge_mask = _greedy_select(
        points, desc, valid & (scores >= params.threshold), params.max_edge,
        params.distance_threshold)
    return planar_idx, planar_mask, edge_idx, edge_mask, scores


def compute_normals(points, mask, params: NormalParams = NormalParams(),
                    chunk: int = 16):
    """Normals for all scans: points [N, P, 2], mask [N, P] -> [N, P, 2]."""
    if params.method != "pca":
        raise NotImplementedError(
            f"normal method {params.method!r} is not ported yet (ROADMAP.md "
            "section 1: only the PCA estimator runs in the port)")
    return torch.cat([_scan_normals(points[i:i + chunk], mask[i:i + chunk],
                                    params)
                      for i in range(0, points.shape[0], chunk)])


def preprocess(points, mask, device,
               feature_params: FeatureParams = FeatureParams(),
               normal_params: NormalParams = NormalParams(),
               config=None):
    """Normals + features for host clouds, computed on ``device``.

    Returns tensors (normals, planar_idx, planar_mask, edge_idx, edge_mask,
    scores).  With a config, the nc_* keys drive the normal estimator.
    """
    if config is not None:
        normal_params = normal_params_from_config(
            config, method=normal_params.method)
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    msk = torch.as_tensor(mask, dtype=torch.bool, device=device)
    normals = compute_normals(pts, msk, normal_params)
    feats = extract_features(pts, msk, feature_params)
    return (normals,) + feats
