"""Flat-tensor problem schema (port of nautilus_tpu/core/problem.py).

- ``SLAMProblem``: immutable observation tensors (clouds, normals, feature
  indices, odometry factors, initial poses), all on one device that the
  caller names.
- ``SLAMState``: problem + the mutable host solution (float64 numpy, as in
  the JAX package) + loop-closure factors.

Feature points are stored as indices into the full cloud, so normals are
always looked up at the exact feature point.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_device(device=None) -> torch.device:
    """``device`` as a torch device; None means the CUDA card.

    The port's entry points run on the card unless the caller names the CPU
    (``device="cpu"``, ``--device cpu``): without a card they raise rather
    than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass device='cpu' "
                           "(--device cpu on the command line) to run on "
                           "the CPU")
    return torch.device("cuda")


class SLAMProblem(NamedTuple):
    """Device tensors for an N-node pose graph.

    Shapes: N nodes, P padded points per cloud, PL planar cap, ED edge cap,
    F odometry factors.  Padding is marked by the *_mask tensors; index
    tensors hold 0 in padded slots (always masked).
    """

    points: torch.Tensor        # [N, P, 2] cloud in each node's sensor frame
    points_mask: torch.Tensor   # [N, P] bool
    normals: torch.Tensor       # [N, P, 2] unit normal per cloud point
    planar_idx: torch.Tensor    # [N, PL] int64 indices into points
    planar_mask: torch.Tensor   # [N, PL] bool
    edge_idx: torch.Tensor      # [N, ED] int64
    edge_mask: torch.Tensor     # [N, ED] bool
    initial_poses: torch.Tensor  # [N, 3]
    odom_i: torch.Tensor        # [F] int64 first pose id per odometry factor
    odom_j: torch.Tensor        # [F] int64 second pose id
    odom_trans: torch.Tensor    # [F, 2] world-frame translation i -> j
    odom_rot: torch.Tensor      # [F] rotation i -> j

    @property
    def num_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    @staticmethod
    def _gather(values, idx):
        return torch.gather(values, 1, idx[..., None].expand(-1, -1, 2))

    @property
    def planar_points(self) -> torch.Tensor:
        """[N, PL, 2] gathered planar feature points."""
        return self._gather(self.points, self.planar_idx)

    @property
    def planar_normals(self) -> torch.Tensor:
        return self._gather(self.normals, self.planar_idx)

    @property
    def edge_points(self) -> torch.Tensor:
        return self._gather(self.points, self.edge_idx)

    @property
    def edge_normals(self) -> torch.Tensor:
        return self._gather(self.normals, self.edge_idx)


@dataclasses.dataclass
class SLAMState:
    """Problem + mutable solution, the unit shared by solver and auto-LC.

    ``solution`` is the authoritative float64 host copy; each solve updates
    it in place.  ``timestamps`` stay on the host for pose-file IO.
    """

    problem: SLAMProblem
    solution: np.ndarray              # [N, 3] float64
    timestamps: np.ndarray            # [N] float64
    # Active odometry factors (i, j, trans, rot) on the host.  A HITL step
    # swaps in the densified solved odometry, then restores the ingest-time
    # factors kept in initial_odometry_factors.
    odometry_factors: tuple = ()
    initial_odometry_factors: tuple = ()
    # Accepted auto-loop-closure factors: (i, j, trans, rot, wt, wr).
    lc_factors: list = dataclasses.field(default_factory=list)
    # HITL line constraints (solve/hitl.HitlConstraint) and their free line
    # poses [L, 3], one per constraint.
    hitl_constraints: list = dataclasses.field(default_factory=list)
    line_poses: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float64))

    @classmethod
    def from_problem(cls, problem: SLAMProblem,
                     timestamps: Optional[np.ndarray] = None) -> "SLAMState":
        init = problem.initial_poses.detach().cpu().numpy().astype(np.float64)
        if timestamps is None:
            timestamps = np.zeros(init.shape[0], dtype=np.float64)
        factors = (problem.odom_i.cpu().numpy(), problem.odom_j.cpu().numpy(),
                   problem.odom_trans.cpu().numpy().astype(np.float64),
                   problem.odom_rot.cpu().numpy().astype(np.float64))
        return cls(problem=problem, solution=init.copy(),
                   timestamps=np.asarray(timestamps, dtype=np.float64),
                   odometry_factors=factors, initial_odometry_factors=factors)

    @property
    def num_nodes(self) -> int:
        return self.solution.shape[0]


class RawNodes(NamedTuple):
    """Host-side ingest output: one padded cloud per captured node."""

    points: np.ndarray       # [N, P, 2] float32
    points_mask: np.ndarray  # [N, P] bool
    initial_poses: np.ndarray  # [N, 3] float64
    timestamps: np.ndarray   # [N] float64
    odom_i: np.ndarray       # [F] int64
    odom_j: np.ndarray       # [F] int64
    odom_trans: np.ndarray   # [F, 2] float64
    odom_rot: np.ndarray     # [F] float64


def pad_clouds(clouds, pad_multiple: int = 128):
    """Stack variable-length clouds [ni, 2] into [N, P, 2] + mask; P is the
    largest cloud rounded up to ``pad_multiple``."""
    n = len(clouds)
    max_pts = max((c.shape[0] for c in clouds), default=0)
    p = max(round_up(max(max_pts, 1), pad_multiple), pad_multiple)
    points = np.zeros((n, p, 2), dtype=np.float32)
    mask = np.zeros((n, p), dtype=bool)
    for i, c in enumerate(clouds):
        k = c.shape[0]
        points[i, :k] = c
        mask[i, :k] = True
    return points, mask


def resolve_solver_dtype(name) -> torch.dtype:
    """Map the ``solver_dtype`` config key to a torch dtype (float32 only)."""
    name = str(name).lower()
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("float64", "f64", "double"):
        raise NotImplementedError(
            "solver_dtype=float64 is not ported yet (ROADMAP.md section 1, "
            "item 'float64')")
    raise ValueError(f"solver_dtype must be float32 or float64, got {name!r}")


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def build_problem(raw: RawNodes, normals, planar_idx, planar_mask, edge_idx,
                  edge_mask, device, dtype=torch.float32) -> SLAMProblem:
    """Assemble the device problem from ingest + preprocessing outputs."""
    f, i64, b = dtype, torch.int64, torch.bool
    return SLAMProblem(
        points=_tensor(raw.points, f, device),
        points_mask=_tensor(raw.points_mask, b, device),
        normals=_tensor(normals, f, device),
        planar_idx=_tensor(planar_idx, i64, device),
        planar_mask=_tensor(planar_mask, b, device),
        edge_idx=_tensor(edge_idx, i64, device),
        edge_mask=_tensor(edge_mask, b, device),
        initial_poses=_tensor(raw.initial_poses, f, device),
        odom_i=_tensor(raw.odom_i, i64, device),
        odom_j=_tensor(raw.odom_j, i64, device),
        odom_trans=_tensor(raw.odom_trans, f, device),
        odom_rot=_tensor(raw.odom_rot, f, device),
    )


_INDEX_FIELDS = ("planar_idx", "edge_idx", "odom_i", "odom_j")
_MASK_FIELDS = ("points_mask", "planar_mask", "edge_mask")


def problem_from_numpy(arrays: dict, device) -> SLAMProblem:
    """SLAMProblem from numpy arrays keyed by field name — e.g. the fields of
    a JAX ``SLAMProblem`` taken with ``np.asarray`` — so a computation can
    start from exactly the state another engine holds."""
    fields = {}
    for name in SLAMProblem._fields:
        dtype = (torch.int64 if name in _INDEX_FIELDS
                 else torch.bool if name in _MASK_FIELDS else torch.float32)
        fields[name] = _tensor(arrays[name], dtype, device)
    return SLAMProblem(**fields)
