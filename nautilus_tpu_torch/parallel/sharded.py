"""Factor-parallel solve and CSM batch over a gloo process group (port of
nautilus_tpu/parallel/sharded.py).

The JAX package drives a mesh of devices from one program: shard_map gives
each device a slice of the factor lists and one psum per LM step sums their
normal equations.  Here the mesh is a controller (rank 0: the calling
process, which runs the LM loop, the damped solve and every decision) and
``size - 1`` worker processes, spawned, in one gloo group:

- each LM step the controller sends the trial x to the workers; every rank
  (the controller too) associates and assembles its slice of the factor
  lists (worker.FactorSlice);
- one reduction of one flat host buffer (``worker.Rank.reduce_sum``, the
  one function that holds it on every rank) then does what psum does, and
  only the controller reads the sum;
- the damped solve and the accept/reject branch run on the controller
  alone, so no rank can take another branch.

Slices are contiguous and may be uneven; an empty slice adds zeros, so
nothing is padded.  On a card rank r works on cuda:(r % device count) and
every collective is staged through the host (gloo moves host tensors).  A
world of size 1 spawns nothing and runs the same code.

The band form reduces the O(N w) band (about 408 KB at N=1000, w=10 in
float32) where the dense form reduces H (36 MB); long-range closures fill
disjoint global columns of the Woodbury block U, by slice.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from multiprocessing.connection import wait
from typing import List, Optional

import numpy as np
import torch

from nautilus_tpu_torch.core.problem import default_device
from nautilus_tpu_torch.parallel import worker
from nautilus_tpu_torch.parallel.worker import Rank, split_buffer, to_host
from nautilus_tpu_torch.solve.factors import (BandedSystem, FactorGraph,
                                              empty_hitl)
from nautilus_tpu_torch.solve.lm import (LMParams, LMResult, lm_loop,
                                         lm_loop_banded)


class Mesh:
    """A controller (this process, rank 0) and ``size - 1`` worker processes
    in one gloo group.  Use it as a context manager, or call ``close``.

    Workers start from the ``spawn`` context (never ``fork``: CUDA), join
    over a file store in a temporary directory (no network; the group talks
    over the loopback interface), and rank r uses cuda:(r % device count)
    on a card.  On the CPU every rank, the controller included while the
    mesh is open, takes cores // size torch threads.  Joining and every
    collective raise after ``worker.TIMEOUT_S``; a worker that dies makes
    the collective in progress raise at once, and the mesh is then closed."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"a mesh needs at least one rank, got {size}")
        self.size = size
        self.device = default_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The device the controller's tensors land on, as a problem's
            # tensors name it.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._procs: list = []
        self._conns: list = []
        self._dir = None
        self._threads = None
        self._sent = {}
        # The FactorSlice specs the ranks hold (set_slices).
        self.slices = None
        self.closed = False
        self.spawn_s = 0.0
        t0 = time.perf_counter()
        pg = None
        try:
            if size > 1:
                pg = self._start()
            self.rank = Rank(pg, self.device)
        except BaseException:
            self.close()
            raise
        self.spawn_s = time.perf_counter() - t0

    def _start(self):
        threads = 0
        if self.device.type == "cpu":
            threads = max(1, (os.cpu_count() or 1) // self.size)
            self._threads = torch.get_num_threads()
            torch.set_num_threads(threads)
        self._dir = tempfile.mkdtemp(prefix="nautilus_mesh_")
        store = os.path.join(self._dir, "store")
        ctx = torch.multiprocessing.get_context("spawn")
        n_cards = torch.cuda.device_count() if self.device.type == "cuda" \
            else 0
        for r in range(1, self.size):
            dev = f"cuda:{r % n_cards}" if n_cards else str(self.device)
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=worker.main, daemon=True,
                               args=(r, self.size, store, dev, threads,
                                     theirs),
                               name=f"nautilus-mesh-rank{r}")
            proc.start()
            theirs.close()
            self._procs.append(proc)
            self._conns.append(ours)
        # Every worker has imported the package before anyone joins: a
        # worker that fails at import raises here, not after the timeout.
        for r, conn in enumerate(self._conns, start=1):
            if not wait([conn, self._procs[r - 1].sentinel],
                        worker.TIMEOUT_S):
                raise RuntimeError(f"mesh rank {r} did not start within "
                                   f"{worker.TIMEOUT_S} s")
            msg = conn.recv() if conn.poll() else ("exited", None)
            if msg[0] != "started":
                raise RuntimeError(f"mesh rank {r} failed to start: "
                                   f"{msg[1] or self._procs[r - 1].exitcode}")
        return worker.make_group(store, 0, self.size)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop and join the workers, then release the group."""
        if self.closed:
            return
        self.closed = True
        for conn in self._conns:
            try:
                conn.send(("stop", None))
            except OSError:
                pass
        for proc in self._procs:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        for conn in self._conns:
            conn.close()
        self.rank = None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
        if self._threads is not None:
            torch.set_num_threads(self._threads)

    def _fail(self, exc: BaseException):
        """Close the mesh after a failed command and raise what the ranks
        reported."""
        notes = []
        for r, (conn, proc) in enumerate(zip(self._conns, self._procs),
                                         start=1):
            try:
                if conn.poll(1.0):
                    kind, text = conn.recv()
                    notes.append(f"rank {r}: {text}")
                    continue
            except (EOFError, OSError):
                pass
            proc.join(1.0)
            if proc.exitcode is not None:
                notes.append(f"rank {r} exited with code {proc.exitcode}")
        self.close()
        raise RuntimeError("the mesh failed and is closed; "
                           + ("; ".join(notes) or str(exc))) from exc

    def command(self, cmd: str, payloads):
        """Send ``cmd`` to every worker (``payloads``: one payload for all,
        or a list with one per rank, rank 0's first), serve it on rank 0 and
        return what the command's collective leaves at rank 0."""
        if self.closed:
            raise RuntimeError("the mesh is closed")
        per_rank = isinstance(payloads, list)
        try:
            for r, conn in enumerate(self._conns, start=1):
                conn.send((cmd, payloads[r] if per_rank else payloads))
        except OSError as exc:
            self._fail(exc)
        try:
            return self.rank.serve(cmd, payloads[0] if per_rank else payloads)
        except BaseException as exc:
            if self.size == 1:
                raise
            self._fail(exc)

    def share_problem(self, problem):
        """Give every rank the replicated problem, once per problem."""
        if self._sent.get("problem") is problem:
            return
        arrays = {f: t.detach().cpu().numpy()
                  for f, t in problem._asdict().items()}
        dtype = str(problem.points.dtype).rsplit(".", 1)[-1]
        self.command("problem", (arrays, dtype))
        self._sent["problem"] = problem

    def share_clouds(self, points, masks):
        """Give every rank a pair list's clouds, once per tensor."""
        if self._sent.get("clouds") is points:
            return
        self.command("clouds", (points.detach().cpu().numpy(),
                                masks.detach().cpu().numpy()))
        self._sent["clouds"] = points

    def set_slices(self, specs: list):
        """Give each rank its FactorSlice, one spec per rank."""
        self.command("slices", specs)
        self.slices = specs

    def launches(self, reset: bool = False) -> List[dict]:
        """Each rank's kernel launch counts, in rank order; zeroed after
        the read when ``reset``."""
        return [{"fused_coarse": int(c[0]), "correlate": int(c[1])}
                for c in self.command("launches", reset)]


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: one per visible card, or one
    per core on the CPU) on ``device`` (default: the card)."""
    dev = default_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" \
            else (os.cpu_count() or 1)
    return Mesh(n_devices, dev)


# ---------------------------------------------------------------------------
# Slices of the factor lists
# ---------------------------------------------------------------------------

def _bounds(count: int, size: int):
    """[lo, hi) of each rank's contiguous share of ``count`` rows, the
    first count % size ranks one row longer."""
    base, extra = divmod(count, size)
    edges = np.cumsum([0] + [base + (r < extra) for r in range(size)])
    return [(int(edges[r]), int(edges[r + 1])) for r in range(size)]


def _slice_specs(size: int, form: str, n: int, L: int, w: int, analytic,
                 odom, hitl=None, lr=None, pairs=None, planar=None,
                 edge=None, outlier: float = 0.0,
                 use_normal_gate: bool = False) -> list:
    """Each rank's worker.FactorSlice spec: contiguous slices of every
    factor list, as host arrays.  ``pairs`` (src, tgt host arrays) are
    associated per window; otherwise ``planar`` and ``edge`` are given."""
    k = 0 if lr is None else lr.count
    shares = {
        "odom": (odom, odom.count),
        "hitl": (hitl, 0 if hitl is None else hitl.node.shape[0]),
        "lr": (lr if k else None, k),
        "planar": (planar, 0 if planar is None else planar.src.shape[0]),
        "edge": (edge, 0 if edge is None else edge.src.shape[0]),
    }
    bounds = {name: _bounds(count, size)
              for name, (_, count) in shares.items()}
    pair_bounds = _bounds(0 if pairs is None else len(pairs[0]), size)
    specs = []
    for r in range(size):
        spec = {"form": form, "n": n, "L": L, "w": w, "analytic": analytic,
                "outlier": float(outlier),
                "use_normal_gate": bool(use_normal_gate),
                "lr_cols": (3 * bounds["lr"][r][0], 3 * k)}
        for name, (batch, _) in shares.items():
            spec[name] = to_host(batch, slice(*bounds[name][r]))
        lo, hi = pair_bounds[r]
        spec["pairs"] = None if pairs is None else (pairs[0][lo:hi],
                                                     pairs[1][lo:hi])
        specs.append(spec)
    return specs


def _assemble(mesh: Mesh, x, window, shapes: dict):
    """The summed normal equations at x, on x's device: (H, g, cost) in
    dense form, (BandedSystem, cost) in band form.  With ``window`` every
    rank associates its pairs at x first."""
    flat = mesh.command("assemble", (x.detach().cpu().numpy(), window))
    p = split_buffer(flat.to(x.device), shapes)
    if "H" in p:
        return p["H"], p["g"], p["cost"]
    lv = p["levels"]
    return BandedSystem(diag=lv[0], band=lv[1:], g=p["g"], U=p.get("U"),
                        C=p.get("C"), E=p.get("E"), gl=p.get("gl")), p["cost"]


def _cost(mesh: Mesh, x):
    flat = mesh.command("cost", x.detach().cpu().numpy())
    return flat.to(x.device)[0]


def make_sharded_fns(mesh: Mesh, graph: FactorGraph):
    """(assemble_fn, cost_fn) over the mesh for a given factor graph: every
    factor list is split into one contiguous slice per rank; assemble_fn(x)
    returns the dense (H, g, cost) summed over the ranks, cost_fn(x) the
    summed cost, both at rank 0 on x's device."""
    specs = shapes = None

    def ensure(x):
        nonlocal specs, shapes
        if specs is None or specs[0]["n"] != x.shape[0]:
            specs = _slice_specs(mesh.size, "dense", x.shape[0], 0, 0, True,
                                 graph.odom, graph.hitl, planar=graph.planar,
                                 edge=graph.edge)
            shapes = worker.buffer_shapes(specs[0])
        if mesh.slices is not specs:
            mesh.set_slices(specs)

    def assemble_fn(x):
        ensure(x)
        return _assemble(mesh, x, None, shapes)

    def cost_fn(x):
        ensure(x)
        return _cost(mesh, x)

    return assemble_fn, cost_fn


def sharded_lm_solve(x0, graph: FactorGraph, fixed_dof, mesh: Mesh,
                     params: LMParams = LMParams()) -> LMResult:
    """lm.lm_solve with the dense assembly spread over the mesh: one
    reduction per assembly and per trial cost."""
    assemble_fn, cost_fn = make_sharded_fns(mesh, graph)
    return lm_loop(x0, assemble_fn, cost_fn, fixed_dof, params)


def _host_index(a) -> np.ndarray:
    return np.asarray(a.cpu() if torch.is_tensor(a) else a, np.int64)


def sharded_sweep(x, problem, pair_src, pair_tgt, odom, hitl, fixed_dof,
                  outlier, w_min: int, w_max: int, mesh: Mesh,
                  lm_params: LMParams = LMParams(),
                  use_normal_gate: bool = False, use_band: bool = False,
                  lr=None, analytic=True):
    """The growing-window sweep with association and assembly spread over
    the mesh: for each window w_min..w_max every rank associates its slice
    of the pair list at the window's starting x, then LM runs on the
    controller with one reduction per assembly (and per trial cost in dense
    form).

    use_band: each rank scatters its slices into the block band
    (factors.assemble_banded_scatter) and the band is reduced instead of
    the dense H; requires every odometry factor and correspondence pair
    within |i - j| <= min(w_max, N - 1).  lr: long-range loop closures
    (Solver._long_range_factors()), band form only; each rank linearizes
    its slice into its own global columns of the Woodbury block U, so the
    sum is exactly the full U.  hitl: HITL rows (None or empty for none).

    Every refusal raises ValueError before any command reaches a worker.
    Returns (x, initial_costs [W], final_costs [W], iterations [W]) with x
    on the mesh's device and the rest as host arrays."""
    n = problem.num_nodes
    w_band = min(w_max, max(n - 1, 0))
    src, tgt = _host_index(pair_src), _host_index(pair_tgt)
    if use_band:
        if odom.span > w_band:
            raise ValueError(
                f"use_band=True requires all odometry factors within "
                f"|i - j| <= {w_band}; found delta {odom.span}.")
        if src.size and int(np.abs(src - tgt).max()) > w_band:
            raise ValueError(
                f"use_band=True requires all correspondence pairs within "
                f"|src - tgt| <= {w_band}; found delta "
                f"{int(np.abs(src - tgt).max())}.")
    if lr is not None and not use_band:
        raise ValueError("lr factors require use_band=True (fold them into "
                         "odom for the dense path)")
    if hitl is None:
        hitl = empty_hitl(x.device, x.dtype)
    form = "band" if use_band else "dense"
    specs = _slice_specs(mesh.size, form, n, x.shape[0] - n, w_band,
                         analytic, odom, hitl, lr, pairs=(src, tgt),
                         outlier=float(outlier),
                         use_normal_gate=use_normal_gate)
    shapes = worker.buffer_shapes(specs[0])
    mesh.share_problem(problem)
    mesh.set_slices(specs)
    windows = range(w_min, w_max + 1)
    initial = np.zeros(len(windows))
    final = np.zeros(len(windows))
    iterations = np.zeros(len(windows), np.int64)
    for k, window in enumerate(windows):
        pending = [window]

        def assemble_fn(xx):
            return _assemble(mesh, xx, pending.pop() if pending else None,
                             shapes)

        if use_band:
            res = lm_loop_banded(x, assemble_fn, fixed_dof, lm_params)
        else:
            res = lm_loop(x, assemble_fn, lambda xx: _cost(mesh, xx),
                          fixed_dof, lm_params)
        x = res.x
        initial[k], final[k] = res.initial_cost, res.cost
        iterations[k] = res.iterations
    return x, initial, final, iterations


# ---------------------------------------------------------------------------
# The CSM batch over the pair dimension
# ---------------------------------------------------------------------------

def csm_match_pairs_sharded(points, masks, src_idx, tgt_idx, mesh: Mesh,
                            params=None, rotation_centers=None):
    """csm_match_pairs(engine="pair") with the pair list split over the
    mesh: each rank matches a contiguous slice of the pairs on its own copy
    of the clouds, and the results are gathered in pair order.  Same
    contract as kernels.csm.csm_match_pairs: host arrays (scores [Q]
    float32, transforms [Q, 3] float32)."""
    from nautilus_tpu_torch.kernels.csm import CSMParams
    params = params or CSMParams()
    src, tgt = _host_index(src_idx), _host_index(tgt_idx)
    q = len(src)
    if q == 0:
        return np.zeros(0, np.float32), np.zeros((0, 3), np.float32)
    centers = np.zeros(q, np.float32) if rotation_centers is None \
        else np.asarray(rotation_centers, np.float32)
    mesh.share_clouds(points, masks)
    bounds = _bounds(q, mesh.size)
    rows = max(hi - lo for lo, hi in bounds)
    parts = mesh.command("csm", [(src[lo:hi], tgt[lo:hi], centers[lo:hi],
                                  params, rows) for lo, hi in bounds])
    out = np.concatenate([part.numpy().reshape(rows, 4)[:hi - lo]
                          for part, (lo, hi) in zip(parts, bounds)])
    return out[:, 0].copy(), out[:, 1:].copy()
