"""Scan-pair descriptor score and local-uncertainty estimate (port of
nautilus_tpu/loop_closure/learned.py).

- ``match_score(scan_a, scan_b)`` in [0, 1]: similarity of two polar
  occupancy histograms of the mean-centred, scaled clouds, maximized over
  all circular shifts of the angle axis (rotation invariant).  Compared
  against the config key ``lc_match_threshold``.
- ``local_uncertainty``: spectrum of a scan's point-to-plane
  self-registration information matrix.
"""

from __future__ import annotations

import math

import torch

RANGE_BINS = 16
THETA_BINS = 64


def normalize_cloud(points, mask, range_scale: float):
    """Mean-centre over the valid points, then divide by range_scale."""
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(points * w[:, None], dim=0) / n
    return (points - mean) / _scalar(range_scale, points)


def _scalar(value: float, like):
    """``value`` as a 0-dim tensor beside ``like``: dividing by a Python
    float becomes a multiply by its reciprocal on CUDA, which can move a
    point on a bin edge."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def scan_descriptor(points, mask, range_scale: float = 10.0):
    """[RANGE_BINS, THETA_BINS] L2-normalized polar occupancy histogram of
    one scan: points [P, 2], mask [P].

    A point whose angle lies within rounding of a bin edge (the +-pi seam
    included) may fall in the neighbouring bin on another backend; that
    moves one vote."""
    dtype = points.dtype
    p = normalize_cloud(points, mask, range_scale)
    r = torch.linalg.vector_norm(p, dim=-1)
    th = torch.atan2(p[:, 1], p[:, 0])
    ri = torch.clamp((r * RANGE_BINS).to(torch.int64), 0, RANGE_BINS - 1)
    ti = torch.clamp(((th + math.pi) / _scalar(2 * math.pi, th) * THETA_BINS)
                     .to(torch.int64), 0, THETA_BINS - 1)
    hist = torch.zeros((RANGE_BINS * THETA_BINS,), dtype=dtype,
                       device=points.device)
    hist.index_add_(0, ri * THETA_BINS + ti, mask.to(dtype))
    hist = hist.reshape(RANGE_BINS, THETA_BINS)
    return hist / torch.sqrt(torch.clamp(torch.sum(hist * hist), min=1e-12))


def match_score(points_a, mask_a, points_b, mask_b) -> torch.Tensor:
    """Rotation-invariant descriptor similarity in [0, 1] (0-dim tensor):
    the largest cosine similarity over the THETA_BINS circular shifts of
    the angle axis."""
    da = scan_descriptor(points_a, mask_a)
    db = scan_descriptor(points_b, mask_b)
    shifts = (torch.arange(THETA_BINS, device=da.device)[None, :]
              - torch.arange(THETA_BINS, device=da.device)[:, None]) \
        % THETA_BINS                                     # [shift, theta]
    rolled = db[:, shifts]                               # [R, shift, theta]
    sims = torch.einsum("rt,rst->s", da, rolled)
    return torch.clamp(torch.max(sims), 0.0, 1.0)


def local_uncertainty(points, mask, normals):
    """(condition, scale) of each scan's self-registration information.

    points/normals [B, P, 2], mask [B, P].  Point-to-plane information
    H = sum_i J_i^T J_i with J_i = [n_x, n_y, n . d(R p)/dtheta]; condition
    is the translation block's eigenvalue ratio, scale is
    1 / sqrt(lambda_min / n_points).
    """
    w = mask.to(points.dtype)
    nx, ny = normals[..., 0], normals[..., 1]
    # d(Rp)/dtheta at theta=0 is (-y, x).
    jth = -points[..., 1] * nx + points[..., 0] * ny
    J = torch.stack([nx, ny, jth], dim=-1) * w[..., None]
    H = torch.einsum("bpi,bpj->bij", J, J)
    tr = H[:, 0, 0] + H[:, 1, 1]
    det = H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = torch.clamp(0.5 * (tr - disc), min=1e-12)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return lam_max / lam_min, 1.0 / torch.sqrt(lam_min / n)
