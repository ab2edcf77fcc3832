"""Local-uncertainty estimate of a scan (port of ``local_uncertainty`` in
nautilus_tpu/loop_closure/learned.py; the descriptor scorer is not ported).
"""

from __future__ import annotations

import torch


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
