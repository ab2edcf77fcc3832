"""What the comparisons that decide ``correct`` share.  Each kind's
comparison (portbench/kinds/<kind>.py) judges what the timed path produced
by the plain reference (portbench/reference), which works from the
benchmark's own scans and never from anything the program made.

A comparison returns {name: value}; the cell's limits file
(portbench/limits/<cell>.json) gives each name its limit, and a run is
correct when every value is finite and at most its limit.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import features, referee


def cost_gap(prob, cfg, factors, x_prog, x_ref):
    """|C(x_prog) - C(x_ref)| / C(x_ref), C the reference's cost at each
    solution's own max-window correspondences.  Two-sided: fewer matches
    can lower the cost of a worse map."""
    c_ref = referee.cost_at(prob, x_ref, cfg, factors)
    c_prog = referee.cost_at(prob, x_prog, cfg, factors)
    return abs(c_prog - c_ref) / c_ref


def problem(scans, keys):
    """(problem, settings, odometry factors, normals) of the reference,
    from the scans and the configuration's keys."""
    feats = features.compute(scans.points, scans.points_mask)
    prob = referee.make_problem(scans.points, scans.points_mask, feats)
    cfg = referee.Settings.from_keys(keys)
    odo = referee.odometry(scans.odom_i, scans.odom_j, scans.odom_trans,
                           scans.odom_rot, cfg.tw, cfg.rw)
    return prob, cfg, odo, feats.normals


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))
