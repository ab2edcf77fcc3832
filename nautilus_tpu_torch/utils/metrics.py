"""Trajectory accuracy metrics: SE(2) alignment and ATE (port of
nautilus_tpu/utils/metrics.py; host numpy).

Beyond-reference utility (ut-amrl/nautilus has no evaluation module —
its quality signal is the Ceres final cost alone): standard trajectory
benchmarks in the sense of Sturm et al.'s TUM RGB-D evaluation, adapted
to SE(2).  Used by bench.py to report map accuracy against the synthetic
worlds' ground truth, and available to users for their own datasets.

All functions are host-side numpy: evaluation is offline and tiny
compared to the solve, so there is nothing to gain from the device.
Poses are [N, 3] rows (x, y, theta).
"""

from __future__ import annotations

import numpy as np


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return np.arctan2(np.sin(a), np.cos(a))


def align_se2(est, ref):
    """Least-squares rigid alignment of ``est`` onto ``ref`` (Horn's
    method in 2D): the SE(2) transform (R, t) minimizing
    sum_i ||R p_i + t - q_i||^2 over the xy tracks.

    Returns (aligned [N, 3], dtheta, t [2]): aligned applies R/t to the
    positions and adds dtheta to the headings.
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    p = est[:, :2]
    q = ref[:, :2]
    pc = p - p.mean(axis=0)
    qc = q - q.mean(axis=0)
    # 2D cross-covariance; optimal rotation angle has the closed form
    # atan2(sum(x_p y_q - y_p x_q), sum(x_p x_q + y_p y_q)).
    s = float(np.sum(pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0]))
    c = float(np.sum(pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1]))
    dtheta = float(np.arctan2(s, c))
    R = np.array([[np.cos(dtheta), -np.sin(dtheta)],
                  [np.sin(dtheta), np.cos(dtheta)]])
    t = q.mean(axis=0) - R @ p.mean(axis=0)
    aligned = np.concatenate([p @ R.T + t,
                              wrap_angle(est[:, 2:3] + dtheta)], axis=1)
    return aligned, dtheta, t


def ate(est, ref, align: bool = True):
    """Absolute trajectory error.

    Returns dict with translational RMSE / mean / max (meters) and
    rotational RMSE (radians, wrapped heading differences), after an
    optimal SE(2) alignment by default (a global gauge freedom is not a
    mapping error).
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if align:
        est, _, _ = align_se2(est, ref)
    d = np.linalg.norm(est[:, :2] - ref[:, :2], axis=1)
    dth = wrap_angle(est[:, 2] - ref[:, 2])
    return {
        "trans_rmse": float(np.sqrt(np.mean(d ** 2))),
        "trans_mean": float(np.mean(d)),
        "trans_max": float(np.max(d)),
        "rot_rmse": float(np.sqrt(np.mean(dth ** 2))),
    }


def _relative(poses, delta):
    """Relative SE(2) transforms pose_i^{-1} o pose_{i+delta}:
    (dx, dy in frame i, dtheta), each [N-delta, ...]."""
    a = poses[:-delta]
    b = poses[delta:]
    dp = b[:, :2] - a[:, :2]
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    local = np.stack([c * dp[:, 0] + s * dp[:, 1],
                      -s * dp[:, 0] + c * dp[:, 1]], axis=1)
    return local, wrap_angle(b[:, 2] - a[:, 2])


def rpe(est, ref, delta: int = 1):
    """Relative pose error at step ``delta`` (drift per delta nodes).

    Gauge-invariant by construction — no alignment needed.  Returns dict
    with translational RMSE / mean (meters) and rotational RMSE (rad).
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if len(est) <= delta:
        raise ValueError(f"need more than {delta} poses, got {len(est)}")
    te, re_ = _relative(est, delta)
    tr, rr = _relative(ref, delta)
    d = np.linalg.norm(te - tr, axis=1)
    dth = wrap_angle(re_ - rr)
    return {
        "trans_rmse": float(np.sqrt(np.mean(d ** 2))),
        "trans_mean": float(np.mean(d)),
        "rot_rmse": float(np.sqrt(np.mean(dth ** 2))),
    }
