"""SE(2) geometry and angle utilities on tensors (port of
nautilus_tpu/core/geometry.py).

A pose is a length-3 tensor [tx, ty, theta]; theta rotates robot->world.
Leading dimensions batch.  Rotations are written elementwise, not as 2x2
matrix products, so they run at full float32 precision on every device.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def angle_mod(angle):
    """Wrap angle to [-pi, pi]: angle - 2 pi * round(angle / 2 pi)."""
    return angle - TWO_PI * torch.round(angle / TWO_PI)


def angle_diff(a0, a1):
    """Signed smallest difference a0 - a1."""
    return angle_mod(a0 - a1)


def angle_dist(a0, a1):
    """Absolute smallest difference."""
    return torch.abs(angle_diff(a0, a1))


def normals_similar(n1, n2, max_cosine_value):
    """|n1 . n2| > max_cosine_value for normals [..., 2]."""
    return torch.abs(torch.sum(n1 * n2, dim=-1)) > max_cosine_value


def rot2d(theta):
    """[..., 2, 2] rotation matrices (robot->world) for angles theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _rot_apply(theta, points):
    """Rotate points [..., 2] by theta (broadcast)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def pose_transform_points(pose, points):
    """Apply SE(2) pose [..., 3] to points [..., 2] (robot->world)."""
    return _rot_apply(pose[..., 2], points) + pose[..., :2]


def pose_inverse_transform_points(pose, points):
    """Apply the inverse of pose to points (world->robot frame)."""
    return _rot_apply(-pose[..., 2], points - pose[..., :2])


def relative_pose_transform_points(source_pose, target_pose, points):
    """Transform points from the source frame into the target frame."""
    world = pose_transform_points(source_pose, points)
    return pose_inverse_transform_points(target_pose, world)


def compose_relative(pose_i, pose_j):
    """World-frame delta from pose i to pose j (translation difference and
    heading difference, the odometry factor convention)."""
    return torch.cat([pose_j[..., :2] - pose_i[..., :2],
                      (pose_j[..., 2] - pose_i[..., 2])[..., None]], dim=-1)


def _safe_norm(v, dim=-1, eps=1e-20):
    """Euclidean norm, floored away from 0."""
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim), min=eps))


def _is_between(val, a, b):
    """val lies in the closed interval spanned by a and b (either order)."""
    return ((val >= a) & (val <= b)) | ((val >= b) & (val <= a))


def distance_to_line_segment(point, seg_start, seg_end):
    """Distance from point(s) [..., 2] to a 2D segment.

    Projects on the infinite line; if the projection's x and y both lie in
    the segment's coordinate spans, the perpendicular distance, else the
    distance to the nearest endpoint.  Safe for zero-length segments.
    """
    d = seg_end - seg_start
    dd = torch.sum(d * d, dim=-1)
    safe_dd = torch.clamp(dd, min=1e-20)
    t = torch.sum((point - seg_start) * d, dim=-1) / safe_dd
    proj = seg_start + t[..., None] * d
    on_segment = (_is_between(proj[..., 0], seg_start[..., 0], seg_end[..., 0])
                  & _is_between(proj[..., 1], seg_start[..., 1],
                                seg_end[..., 1]))
    rel = point - seg_start
    cross = d[..., 0] * rel[..., 1] - d[..., 1] * rel[..., 0]
    perp = torch.abs(cross) / _safe_norm(d)
    d_start = _safe_norm(point - seg_start)
    d_end = _safe_norm(point - seg_end)
    endpoint_dist = torch.minimum(d_start, d_end)
    degenerate = dd < 1e-20
    return torch.where(degenerate, d_start,
                       torch.where(on_segment, perp, endpoint_dist))


def scatter_matrix_score(points, mask=None):
    """lambda_min / lambda_max of the 2D scatter matrix of a point set.

    points [..., M, 2]; mask [..., M] bool.  Returns the score in [0, 1] per
    batch element; 0 where fewer than 2 points are valid.
    """
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                          device=points.device)
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(points * w[..., None], dim=-2) / n[..., None]
    centered = (points - mean[..., None, :]) * w[..., None]
    sxx = torch.sum(centered[..., 0] * centered[..., 0], dim=-1)
    sxy = torch.sum(centered[..., 0] * centered[..., 1], dim=-1)
    syy = torch.sum(centered[..., 1] * centered[..., 1], dim=-1)
    tr = sxx + syy
    disc = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy, min=0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = 0.5 * (tr - disc)
    score = lam_min / torch.clamp(lam_max, min=1e-20)
    valid = torch.sum(mask, dim=-1) >= 2
    return torch.where(valid, torch.clamp(score, 0.0, 1.0),
                       torch.zeros_like(score))
