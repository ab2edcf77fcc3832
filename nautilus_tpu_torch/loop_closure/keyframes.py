"""Local-uncertainty criterion for auto-LC candidates (port of
``candidate_uncertainty_ok`` in nautilus_tpu/loop_closure/keyframes.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nautilus_tpu_torch.core.problem import SLAMState
from nautilus_tpu_torch.loop_closure.learned import local_uncertainty


def candidate_uncertainty_ok(state: SLAMState, config, nodes) -> np.ndarray:
    """Bool mask over ``nodes``: each node's scan, merged with its
    ``local_uncertainty_prev_scans`` predecessors in the node's frame (via
    the current solution), is well conditioned
    (condition < local_uncertainty_condition_threshold and
    scale < local_uncertainty_scale_threshold)."""
    idx = np.asarray(nodes, np.int64)
    if idx.size == 0:
        return np.zeros(0, bool)
    cond_thresh = float(config.get("local_uncertainty_condition_threshold",
                                   9.5))
    scale_thresh = float(config.get("local_uncertainty_scale_threshold", 2.5))
    prev_scans = int(config.get("local_uncertainty_prev_scans", 2))

    prob = state.problem
    dev = prob.device
    pts, msk, nrm = prob.points, prob.points_mask, prob.normals
    sol = torch.as_tensor(state.solution, dtype=pts.dtype, device=dev)
    node = torch.as_tensor(idx, device=dev)
    th_i, t_i = sol[node, 2], sol[node, :2]
    c_i, s_i = torch.cos(th_i), torch.sin(th_i)
    pieces_p, pieces_m, pieces_n = [], [], []
    for s in range(prev_scans + 1):
        j = torch.clamp(node - s, min=0)
        pj, nj = pts[j], nrm[j]
        mj = msk[j] & (node >= s)[:, None]
        th_j, t_j = sol[j, 2], sol[j, :2]
        # node j frame -> world -> node i frame: R(-th_i)(R(th_j) p + t_j
        # - t_i); normals rotate by th_j - th_i.
        dth = th_j - th_i
        c, sn = torch.cos(dth)[:, None], torch.sin(dth)[:, None]
        px = c * pj[..., 0] - sn * pj[..., 1]
        py = sn * pj[..., 0] + c * pj[..., 1]
        dt = t_j - t_i
        dx = c_i[:, None] * dt[:, None, 0] + s_i[:, None] * dt[:, None, 1]
        dy = -s_i[:, None] * dt[:, None, 0] + c_i[:, None] * dt[:, None, 1]
        pieces_p.append(torch.stack([px + dx, py + dy], dim=-1))
        pieces_n.append(torch.stack([c * nj[..., 0] - sn * nj[..., 1],
                                     sn * nj[..., 0] + c * nj[..., 1]], dim=-1))
        pieces_m.append(mj)
    conds, scales = local_uncertainty(torch.cat(pieces_p, dim=1),
                                      torch.cat(pieces_m, dim=1),
                                      torch.cat(pieces_n, dim=1))
    conds, scales = conds.cpu().numpy(), scales.cpu().numpy()
    return (conds < cond_thresh) & (scales < scale_thresh)
