"""The benchmark's input maker: a segment world, a ground-truth loop
trajectory, scans raycast from it and drifted odometry, all from a seed.

A frozen numpy copy of the port's synthetic generator (the same draws for
the same seed), so the inputs do not move when the program changes.  The
benchmark hands the arrays made here to the program and to the reference
alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Scans(NamedTuple):
    """One recorded run: padded clouds, initial poses and odometry."""

    points: np.ndarray        # [N, P, 2] float32, sensor frame
    points_mask: np.ndarray   # [N, P] bool
    initial_poses: np.ndarray  # [N, 3] float64, integrated noisy odometry
    timestamps: np.ndarray    # [N] float64
    odom_i: np.ndarray        # [F] int64
    odom_j: np.ndarray        # [F] int64
    odom_trans: np.ndarray    # [F, 2] float64, world-frame deltas
    odom_rot: np.ndarray      # [F] float64
    gt: np.ndarray            # [N, 3] ground-truth poses


def make_world(kind: str) -> np.ndarray:
    """Wall segments [S, 2, 2] ((start, end) per row)."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([[[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]],
                     [[x1, y1], [x0, y1]], [[x0, y1], [x0, y0]]])

    if kind == "office":
        box(-10, -10, 10, 10)
        segs.extend([[[-10, -2], [-2, -2]], [[2, -2], [10, -2]],
                     [[-10, 3], [-4, 3]], [[0, 3], [10, 3]],
                     [[-2, -10], [-2, -6]], [[3, 3], [3, 10]]])
    elif kind == "building":
        # A 40 x 30 m floor with corridors (GDC-like scale).
        box(-20, -15, 20, 15)
        segs.extend([[[-20, -5], [-5, -5]], [[0, -5], [20, -5]],
                     [[-20, 5], [-12, 5]], [[-8, 5], [8, 5]],
                     [[12, 5], [20, 5]], [[-12, -15], [-12, -8]],
                     [[-5, -5], [-5, 2]], [[5, 5], [5, 12]],
                     [[12, -5], [12, 2]], [[-2, -15], [-2, -9]],
                     [[8, -12], [8, -5]]])
    else:
        raise ValueError(f"unknown world {kind!r}")
    return np.asarray(segs, dtype=np.float64)


def raycast(world, pose, num_beams: int, max_range: float) -> np.ndarray:
    """Ranges [B] from pose [3] against the walls over 360 degrees; inf
    where nothing lies within max_range."""
    angles = pose[2] + np.linspace(-np.pi, np.pi, num_beams, endpoint=False)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    o = pose[:2]
    a, b = world[:, 0], world[:, 1]
    e = b - a
    ao = a[None, :, :] - o[None, None, :]
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (ao[..., 0] * e[None, :, 1] - ao[..., 1] * e[None, :, 0]) / denom
    u = (ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]) / denom
    hit = (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    ranges = np.min(np.where(hit, t, np.inf), axis=-1)
    return np.where(ranges <= max_range, ranges, np.inf)


def scan_to_points(ranges, max_range: float,
                   range_min: float = 0.02) -> np.ndarray:
    """Polar to Cartesian in the sensor frame, invalid ranges dropped."""
    angles = np.linspace(-np.pi, np.pi, len(ranges), endpoint=False)
    keep = (ranges >= range_min) & (ranges <= max_range) & np.isfinite(ranges)
    r, th = ranges[keep], angles[keep]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)


def make_trajectory(num_nodes: int, world_kind: str,
                    step: float = 0.25) -> np.ndarray:
    """Ground-truth poses [N, 3] on an ellipse inside the world, heading
    along it, ``step`` metres apart."""
    radius = {"office": 6.0, "building": 11.0}[world_kind]
    laps = num_nodes * step / (2 * np.pi * radius)
    t = np.linspace(0, 2 * np.pi * laps, num_nodes, endpoint=False)
    x = radius * np.cos(t)
    y = radius * 0.75 * np.sin(t)
    heading = np.arctan2(np.gradient(y), np.gradient(x))
    return np.stack([x, y, heading], axis=-1)


def pad_clouds(clouds, pad_multiple: int = 128):
    """Stack clouds [ni, 2] into [N, P, 2] float32 + mask; P is the largest
    cloud rounded up to pad_multiple."""
    longest = max((len(c) for c in clouds), default=0)
    p = max(-(-max(longest, 1) // pad_multiple) * pad_multiple, pad_multiple)
    points = np.zeros((len(clouds), p, 2), np.float32)
    mask = np.zeros((len(clouds), p), bool)
    for i, c in enumerate(clouds):
        points[i, :len(c)] = c
        mask[i, :len(c)] = True
    return points, mask


def raycast_run(num_nodes: int, world_kind: str, num_beams: int,
                max_range: float) -> Scans:
    """The scans of a run along the ground-truth loop, without odometry."""
    world = make_world(world_kind)
    gt = make_trajectory(num_nodes, world_kind)
    clouds = [scan_to_points(raycast(world, gt[i], num_beams, max_range),
                             max_range).astype(np.float32)
              for i in range(num_nodes)]
    points, mask = pad_clouds(clouds)
    none = np.zeros(0)
    return Scans(points=points, points_mask=mask, initial_poses=none,
                 timestamps=np.arange(num_nodes, dtype=np.float64) * 0.5 + 1e9,
                 odom_i=np.arange(num_nodes - 1, dtype=np.int64),
                 odom_j=np.arange(1, num_nodes, dtype=np.int64),
                 odom_trans=none, odom_rot=none, gt=gt)


def with_drift(run: Scans, odom_noise_trans: float, odom_noise_rot: float,
               seed: int) -> Scans:
    """The run's odometry for ``seed``: the ground-truth world-frame deltas
    plus Gaussian drift, and initial poses integrated from them, so the
    initial map is bent as after a replay."""
    rng = np.random.default_rng(seed)
    gt = run.gt
    d_trans = gt[1:, :2] - gt[:-1, :2]
    d_rot = gt[1:, 2] - gt[:-1, 2]
    d_trans = d_trans + rng.normal(scale=odom_noise_trans, size=d_trans.shape)
    d_rot = d_rot + rng.normal(scale=odom_noise_rot, size=d_rot.shape)
    init = np.zeros_like(gt)
    init[0] = gt[0]
    init[1:, :2] = gt[0, :2] + np.cumsum(d_trans, axis=0)
    init[1:, 2] = gt[0, 2] + np.cumsum(d_rot)
    return run._replace(initial_poses=init, odom_trans=d_trans,
                        odom_rot=d_rot)


def synthesize(num_nodes: int, world_kind: str, num_beams: int,
               max_range: float, odom_noise_trans: float,
               odom_noise_rot: float, seed: int) -> Scans:
    """The run for ``seed``: scans raycast along the loop and drifted
    odometry."""
    return with_drift(raycast_run(num_nodes, world_kind, num_beams,
                                  max_range),
                      odom_noise_trans, odom_noise_rot, seed)
