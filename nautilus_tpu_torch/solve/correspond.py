"""Batched correspondence search (port of nautilus_tpu/solve/correspond.py).

For every (source, target) pose pair, each source feature is moved into the
target frame and matched to the nearest target feature within
``outlier_threshold`` (optionally only among targets whose normal is within
the |cos| gate).  Pairs farther apart than the current window are masked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nautilus_tpu_torch.core import geometry as geo
from nautilus_tpu_torch.core.problem import SLAMProblem
from nautilus_tpu_torch.solve.factors import Correspondences


class PairList(NamedTuple):
    """Static (source, target) pair enumeration for a max window size."""

    src: np.ndarray  # [Q] int64, src > tgt
    tgt: np.ndarray  # [Q] int64


def make_pairs(num_nodes: int, max_window: int) -> PairList:
    """All pairs (i, j) with i - max_window <= j < i, delta-major: for each
    delta = i - j in 1..max_window, the pairs (i, i - delta) with i
    ascending.  The band assembly relies on this order."""
    src, tgt = [], []
    for d in range(1, max_window + 1):
        for i in range(d, num_nodes):
            src.append(i)
            tgt.append(i - d)
    return PairList(np.asarray(src, np.int64), np.asarray(tgt, np.int64))


def associate(problem: SLAMProblem, x, pair_src, pair_tgt, window: int,
              outlier_threshold: float, feature: str = "planar",
              use_normal_gate: bool = False,
              normal_gate_cos: float = 0.9396926) -> Correspondences:
    """Match every pair's features at the current solution x [N, 3].

    feature: "planar" | "edge".  Ties in the nearest-target search go to
    the first index, as in the JAX package.
    """
    if feature == "planar":
        pts, msk = problem.planar_points, problem.planar_mask
        nrm = problem.planar_normals
    elif feature == "edge":
        pts, msk = problem.edge_points, problem.edge_mask
        nrm = problem.edge_normals
    elif feature == "all":
        raise NotImplementedError(
            "optimization_type 'all' (associate_chunked) is not ported yet "
            "(ROADMAP.md section 1, 'associate_chunked')")
    else:
        raise ValueError(feature)

    pair_valid = (pair_src - pair_tgt) <= window                  # [Q]
    src_pts, tgt_pts = pts[pair_src], pts[pair_tgt]               # [Q, S/T, 2]
    proj = geo.relative_pose_transform_points(
        x[pair_src][:, None, :], x[pair_tgt][:, None, :], src_pts)
    diff = proj[:, :, None, :] - tgt_pts[:, None, :, :]           # [Q, S, T, 2]
    d2 = torch.sum(diff * diff, dim=-1)                           # [Q, S, T]
    ok = msk[pair_tgt][:, None, :]
    src_nrm, tgt_nrm = nrm[pair_src], nrm[pair_tgt]
    if use_normal_gate:
        sim = torch.abs(torch.sum(src_nrm[:, :, None, :]
                                  * tgt_nrm[:, None, :, :], dim=-1))
        ok = ok & (sim > normal_gate_cos)
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    nn = torch.argmin(d2, dim=-1)                                 # [Q, S]
    dmin = torch.amin(d2, dim=-1)
    valid = (msk[pair_src] & (dmin < outlier_threshold ** 2)
             & pair_valid[:, None])
    gather = nn[..., None].expand(-1, -1, 2)
    return Correspondences(
        src=pair_src, tgt=pair_tgt,
        src_pts=src_pts, tgt_pts=torch.gather(tgt_pts, 1, gather),
        src_nrm=src_nrm, tgt_nrm=torch.gather(tgt_nrm, 1, gather),
        mask=valid)
