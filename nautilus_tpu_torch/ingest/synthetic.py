"""Synthetic 2D lidar worlds: raycast scans + drifted odometry (port of
nautilus_tpu/ingest/synthetic.py).

Host numpy, identical to the JAX package's generator for the same seed:
a segment world, a ground-truth trajectory, scans raycast from it, and
odometry factors = ground-truth world-frame deltas + Gaussian drift, with
initial poses integrated from the noisy odometry.  ``make_problem`` and
``reverse_traversal_problem`` then preprocess on the requested device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nautilus_tpu_torch.core.problem import (RawNodes, default_device,
                                             pad_clouds)


def make_world(kind: str = "office") -> np.ndarray:
    """Returns wall segments [S, 2, 2] ((start, end) per row)."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([
            [[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]],
            [[x1, y1], [x0, y1]], [[x0, y1], [x0, y0]],
        ])

    if kind == "corner":
        segs.extend([[[0.0, 0.0], [4.0, 0.0]], [[0.0, 0.0], [0.0, 4.0]]])
    elif kind == "room":
        box(-5, -5, 5, 5)
    elif kind == "office":
        box(-10, -10, 10, 10)
        segs.extend([
            [[-10, -2], [-2, -2]], [[2, -2], [10, -2]],
            [[-10, 3], [-4, 3]], [[0, 3], [10, 3]],
            [[-2, -10], [-2, -6]], [[3, 3], [3, 10]],
        ])
    elif kind == "building":
        # Large multi-corridor floor plan (gdc-like scale).
        box(-20, -15, 20, 15)
        segs.extend([
            [[-20, -5], [-5, -5]], [[0, -5], [20, -5]],
            [[-20, 5], [-12, 5]], [[-8, 5], [8, 5]], [[12, 5], [20, 5]],
            [[-12, -15], [-12, -8]], [[-5, -5], [-5, 2]],
            [[5, 5], [5, 12]], [[12, -5], [12, 2]],
            [[-2, -15], [-2, -9]], [[8, -12], [8, -5]],
        ])
    else:
        raise ValueError(kind)
    return np.asarray(segs, dtype=np.float64)


def raycast(world: np.ndarray, pose: np.ndarray, num_beams: int = 360,
            fov: float = 2.0 * np.pi, max_range: float = 30.0) -> np.ndarray:
    """Ranges [B] from pose [3] against world segments; inf where no hit."""
    angles = pose[2] + np.linspace(-fov / 2, fov / 2, num_beams,
                                   endpoint=False)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)    # [B, 2]
    o = pose[:2]
    a = world[:, 0]                                            # [S, 2]
    b = world[:, 1]
    e = b - a                                                  # [S, 2]
    ao = a[None, :, :] - o[None, None, :]                      # [1, S, 2]
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (ao[..., 0] * e[None, :, 1] - ao[..., 1] * e[None, :, 0]) / denom
    u = (ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]) / denom
    hit = (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    ranges = np.min(t, axis=-1)
    return np.where(ranges <= max_range, ranges, np.inf)


def scan_to_points(ranges: np.ndarray, fov: float = 2.0 * np.pi,
                   range_min: float = 0.02,
                   max_range: float = 30.0) -> np.ndarray:
    """Polar -> Cartesian in the sensor frame, dropping invalid ranges
    (reference LaserScanToPointCloud, pointcloud_helpers.cc:28-48)."""
    num_beams = len(ranges)
    angles = np.linspace(-fov / 2, fov / 2, num_beams, endpoint=False)
    keep = (ranges >= range_min) & (ranges <= max_range) & np.isfinite(ranges)
    r = ranges[keep]
    th = angles[keep]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)


def make_trajectory(num_nodes: int, world_kind: str,
                    step: float = 0.25) -> np.ndarray:
    """Ground-truth poses [N, 3] tracing a loop inside the world."""
    if world_kind == "corner":
        # Short push toward/along the corner.
        xs = 1.5 + step * np.arange(num_nodes)
        poses = np.stack([xs * 0.3 + 0.8, xs * 0.2 + 0.8,
                          np.full(num_nodes, 0.3)], axis=-1)
        return poses
    if world_kind == "room":
        radius = 2.5
    elif world_kind == "office":
        radius = 6.0
    else:
        radius = 11.0
    # Loop trajectory: heading tangent to a rounded-rectangle-ish circle.
    total = num_nodes * step
    laps = total / (2 * np.pi * radius)
    t = np.linspace(0, 2 * np.pi * laps, num_nodes, endpoint=False)
    x = radius * np.cos(t)
    y = radius * 0.75 * np.sin(t)
    heading = np.arctan2(np.gradient(y), np.gradient(x))
    return np.stack([x, y, heading], axis=-1)


def synthesize(num_nodes: int = 30, world_kind: str = "office",
               num_beams: int = 720, max_range: float = 30.0,
               odom_noise_trans: float = 0.01, odom_noise_rot: float = 0.004,
               range_noise: float = 0.0, seed: int = 0,
               pad_multiple: int = 128) -> Tuple[RawNodes, np.ndarray]:
    """Build a RawNodes problem + ground-truth poses.

    Odometry factors carry the world-frame delta between consecutive
    ground-truth poses plus Gaussian drift; initial poses integrate those
    noisy deltas so the initial map is bent, as after bag replay.
    """
    rng = np.random.default_rng(seed)
    world = make_world(world_kind)
    gt = make_trajectory(num_nodes, world_kind)

    clouds = []
    for i in range(num_nodes):
        ranges = raycast(world, gt[i], num_beams=num_beams,
                         max_range=max_range)
        if range_noise:
            ranges = ranges + rng.normal(scale=range_noise, size=ranges.shape)
        clouds.append(scan_to_points(ranges, max_range=max_range).astype(
            np.float32))

    # Odometry: world-frame deltas (reference convention) + noise.
    d_trans = gt[1:, :2] - gt[:-1, :2]
    d_rot = gt[1:, 2] - gt[:-1, 2]
    d_trans = d_trans + rng.normal(scale=odom_noise_trans, size=d_trans.shape)
    d_rot = d_rot + rng.normal(scale=odom_noise_rot, size=d_rot.shape)

    init = np.zeros_like(gt)
    init[0] = gt[0]
    init[1:, :2] = gt[0, :2] + np.cumsum(d_trans, axis=0)
    init[1:, 2] = gt[0, 2] + np.cumsum(d_rot)

    points, mask = pad_clouds(clouds, pad_multiple=pad_multiple)
    n_factors = num_nodes - 1
    raw = RawNodes(
        points=points, points_mask=mask,
        initial_poses=init,
        timestamps=np.arange(num_nodes, dtype=np.float64) * 0.5 + 1e9,
        odom_i=np.arange(n_factors, dtype=np.int64),
        odom_j=np.arange(1, num_nodes, dtype=np.int64),
        odom_trans=d_trans, odom_rot=d_rot)
    return raw, gt


def _state_from_raw(raw: RawNodes, device):
    from nautilus_tpu_torch.core.preprocess import preprocess
    from nautilus_tpu_torch.core.problem import SLAMState, build_problem

    normals, pidx, pmask, eidx, emask, _ = preprocess(
        raw.points, raw.points_mask, device)
    problem = build_problem(raw, normals, pidx, pmask, eidx, emask, device)
    return SLAMState.from_problem(problem, timestamps=raw.timestamps)


def reverse_traversal_problem(seed: int = 3, device=None):
    """A path re-traversed in the OPPOSITE direction, the hard loop-closure
    case the angle-seeded CSM exists for: a lead-in leg, a forward pass at
    heading 0 and a return pass at heading pi, slightly offset in y, in a
    box whose interior stubs break its 180-degree symmetry.  Forward-pass
    nodes are 6..18, return-pass nodes 19..31.  ``device`` None means the
    CUDA card (raises without one); pass "cpu" for the CPU.  Returns
    (state, gt).
    """
    device = default_device(device)
    rng = np.random.default_rng(seed)
    half, span = 6.0, 4.5
    segs = [[[-half, -half], [half, -half]],
            [[half, -half], [half, half]],
            [[half, half], [-half, half]],
            [[-half, half], [-half, -half]],
            [[-3, -half], [-3, -half + 2]], [[2, half - 2], [2, half]],
            [[-half, 4], [-half + 2, 4]], [[4, -4], [half, -4]]]
    world = np.asarray(segs, np.float64)
    ys0 = np.linspace(half - 1.5, 0.3, 6)
    xs_f = np.linspace(-span, span, 13)
    xs_r = np.linspace(span, -span, 13)
    gt = np.concatenate([
        np.stack([np.full(6, -span), ys0, np.full(6, -np.pi / 2)], axis=-1),
        np.stack([xs_f, np.full(13, -0.2), np.zeros(13)], axis=-1),
        np.stack([xs_r, np.full(13, 0.2), np.full(13, np.pi)], axis=-1)])
    num_nodes = len(gt)
    clouds = [scan_to_points(raycast(world, gt[i], 720, max_range=10),
                             max_range=10).astype(np.float32)
              for i in range(num_nodes)]
    d_trans = gt[1:, :2] - gt[:-1, :2]
    d_rot = np.arctan2(np.sin(gt[1:, 2] - gt[:-1, 2]),
                       np.cos(gt[1:, 2] - gt[:-1, 2]))
    d_trans = d_trans + rng.normal(scale=0.02, size=d_trans.shape)
    d_rot = d_rot + rng.normal(scale=0.008, size=d_rot.shape)
    init = np.zeros_like(gt)
    init[0] = gt[0]
    init[1:, :2] = gt[0, :2] + np.cumsum(d_trans, axis=0)
    init[1:, 2] = gt[0, 2] + np.cumsum(d_rot)
    points, mask = pad_clouds(clouds, pad_multiple=128)
    raw = RawNodes(
        points=points, points_mask=mask, initial_poses=init,
        timestamps=np.arange(num_nodes, dtype=np.float64) * 0.5 + 1e9,
        odom_i=np.arange(num_nodes - 1, dtype=np.int64),
        odom_j=np.arange(1, num_nodes, dtype=np.int64),
        odom_trans=d_trans, odom_rot=d_rot)
    return _state_from_raw(raw, device), gt


def make_problem(num_nodes: int = 30, world_kind: str = "office",
                 seed: int = 0, device=None, **kw):
    """Convenience: synthesize + preprocess + build the problem/state on
    ``device`` (None means the CUDA card, and raises without one; pass
    "cpu" for the CPU).  Returns (state, gt)."""
    device = default_device(device)
    raw, gt = synthesize(num_nodes=num_nodes, world_kind=world_kind,
                         seed=seed, **kw)
    return _state_from_raw(raw, device), gt
