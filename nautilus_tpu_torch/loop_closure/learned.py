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

from nautilus_tpu_torch.core.preprocess import _fma, _sqrt, _sum_fixed

RANGE_BINS = 16
THETA_BINS = 64


def normalize_cloud(points, mask, range_scale: float):
    """Mean-centre over the valid points, then scale by 1 / range_scale
    (points [..., P, 2], mask [..., P]).  The mean sums in the JAX CPU
    backend's order and the scale is a multiply by the float32 reciprocal,
    as the JAX package's compiled descriptor computes it, so the centred
    points have its bits on every device."""
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = _sum_fixed((points * w[..., None]).transpose(-1, -2)) / n[..., None]
    return (points - mean[..., None, :]) * _scalar(1.0 / range_scale, points)


def _scalar(value: float, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype and device, so that
    CPU and CUDA round the same product or quotient."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def scan_descriptor(points, mask, range_scale: float = 10.0):
    """[..., RANGE_BINS, THETA_BINS] L2-normalized polar occupancy
    histograms of scans: points [..., P, 2], mask [..., P].

    The bins are computed alike on every device, and as the JAX package's
    compiled descriptor computes them: the range as sqrt(fma(y, y, x*x)),
    correctly rounded; the angle bin as (theta + pi) * float32(1 / 2pi) *
    THETA_BINS.  The angle itself is computed in float64 and rounded; a
    point whose angle lies within an ulp of a bin edge may still fall in
    the neighbouring bin of the JAX package's float32 angle, which moves
    one vote."""
    dtype = points.dtype
    batch = points.shape[:-2]
    p = normalize_cloud(points, mask, range_scale)
    x, y = p[..., 0], p[..., 1]
    r = _sqrt(_fma(y, y, x * x))
    th = torch.atan2(y.double(), x.double()).to(dtype)
    ri = torch.clamp((r * RANGE_BINS).to(torch.int64), 0, RANGE_BINS - 1)
    ti = torch.clamp(((th + math.pi) * _scalar(0.5 / math.pi, th) * THETA_BINS)
                     .to(torch.int64), 0, THETA_BINS - 1)
    flat = (ri * THETA_BINS + ti).reshape(-1, ri.shape[-1])
    hist = torch.zeros((flat.shape[0], RANGE_BINS * THETA_BINS), dtype=dtype,
                       device=points.device)
    hist.scatter_add_(1, flat, mask.to(dtype).reshape(flat.shape))
    hist = hist.reshape(*batch, RANGE_BINS, THETA_BINS)
    norm = torch.sum(hist * hist, dim=(-2, -1), keepdim=True)
    return hist / torch.sqrt(torch.clamp(norm, min=1e-12))


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


def passes_uncertainty_filter(points, mask, normals, config) -> bool:
    """Keyframe gate of one scan (points/normals [P, 2], mask [P]):
    condition below local_uncertainty_condition_threshold and scale below
    local_uncertainty_scale_threshold."""
    cond, scale = local_uncertainty(points[None], mask[None], normals[None])
    cond_max = float(config.local_uncertainty_condition_threshold)
    scale_max = float(config.local_uncertainty_scale_threshold)
    return float(cond[0]) < cond_max and float(scale[0]) < scale_max
