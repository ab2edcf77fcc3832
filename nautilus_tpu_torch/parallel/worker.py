"""One rank of a mesh: its share of the factor-parallel work, and the worker
processes' command loop (parallel/sharded.py holds the controller's side).

Every rank, the controller (rank 0) included, serves the same commands
through ``Rank.serve``:

- ``problem``: the replicated SLAMProblem, kept until the next one;
- ``clouds``: the scan clouds of a CSM pair list, kept likewise;
- ``slices``: this rank's share of a solve's factor lists (``FactorSlice``);
- ``assemble``: associate at x when a window is given, then assemble the
  slice into one flat host buffer, summed to rank 0;
- ``cost``: the slice's cost at x, summed to rank 0;
- ``csm``: scan-match the rank's share of a pair list with the pair engine
  (the correlation kernel on a card), gathered to rank 0 in rank order;
- ``launches``: the rank's kernel launch counts, gathered to rank 0;
- ``stop`` (workers only).

A worker receives each command and its host payload over its pipe from the
controller, and answers through the gloo group.  gloo moves host tensors
only, so on a card every collective is staged through one host buffer.
"""

from __future__ import annotations

import datetime
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nautilus_tpu_torch.core.problem import problem_from_numpy
from nautilus_tpu_torch.solve import correspond
from nautilus_tpu_torch.solve.factors import (Correspondences, FactorGraph,
                                              HitlFactors, OdomFactors,
                                              assemble_banded_scatter,
                                              assemble_normal_equations,
                                              lowrank_factor_columns,
                                              total_cost)


# Seconds after which starting a worker, joining the group and every
# collective raise.  A worker that dies makes the collective in progress
# raise at once, so this bounds only a rank that hangs.
TIMEOUT_S = 120.0


def make_group(store_path: str, rank: int, size: int):
    """The gloo group of a mesh over a file store, on the loopback interface:
    joining and every collective raise after TIMEOUT_S."""
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.FileStore(store_path, size)
    store.set_timeout(timeout)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(store, rank, size, opts)


def gather_to_root(pg, flat: torch.Tensor):
    """Every rank's flat host buffer (one length on all ranks), in rank
    order, at rank 0; None on the other ranks."""
    opts = dist.GatherOptions()
    opts.rootRank = 0
    if pg.rank() != 0:
        pg.gather([], [flat], opts).wait()
        return None
    out = [torch.empty_like(flat) for _ in range(pg.size())]
    pg.gather([out], [flat], opts).wait()
    return out


def to_host(batch, rows=slice(None)) -> Optional[dict]:
    """The tensors of a factor batch (OdomFactors, Correspondences,
    HitlFactors), rows ``rows``, as {field: numpy array}."""
    if batch is None:
        return None
    return {f: v[rows].detach().cpu().numpy()
            for f, v in batch._asdict().items() if torch.is_tensor(v)}


def from_host(cls, arrays: Optional[dict], device):
    """Inverse of to_host on ``device``; OdomFactors gets its span."""
    if arrays is None:
        return None
    fields = {f: torch.as_tensor(a, device=device) for f, a in arrays.items()}
    if cls is OdomFactors:
        fields["span"] = _span(arrays["i"], arrays["j"])
    return cls(**fields)


def _span(a, b) -> int:
    return int(np.abs(np.asarray(a) - np.asarray(b)).max()) if len(a) else 0


def buffer_shapes(spec: dict) -> dict:
    """Name -> shape of the pieces of a slice's flat buffer, in order.

    Dense form: H [3M, 3M], g [3M], cost.  Band form: the band levels
    [w+1, n, 3, 3] (level 0 the diagonal), g [n, 3], the Woodbury columns U
    [3n, 3K] of all K long-range closures (each rank fills its own columns),
    the HITL border C, E, gl when there are L line poses, cost."""
    n, L = spec["n"], spec["L"]
    if spec["form"] == "dense":
        d = 3 * (n + L)
        return {"H": (d, d), "g": (d,), "cost": ()}
    shapes = {"levels": (spec["w"] + 1, n, 3, 3), "g": (n, 3)}
    if spec["lr_cols"][1]:
        shapes["U"] = (3 * n, spec["lr_cols"][1])
    if L:
        shapes.update(C=(n, L, 3, 3), E=(L, 3, 3), gl=(L, 3))
    shapes["cost"] = ()
    return shapes


def split_buffer(flat: torch.Tensor, shapes: dict) -> dict:
    """The pieces of a flat buffer laid out by buffer_shapes."""
    out, k = {}, 0
    for name, shape in shapes.items():
        size = int(np.prod(shape))
        out[name] = flat[k:k + size].reshape(shape)
        k += size
    return out


class FactorSlice:
    """One rank's share of a solve's factor lists.

    ``spec`` (built by parallel/sharded.py) holds, as host arrays, the
    rank's contiguous slices of the odometry, HITL and long-range lists, and
    either its slice of the pair list (associated per window against the
    replicated problem) or its slices of given correspondence batches."""

    def __init__(self, spec: dict, device, problem=None):
        self.spec = spec
        self.shapes = buffer_shapes(spec)
        self.problem = problem
        self.odom = from_host(OdomFactors, spec["odom"], device)
        self.hitl = from_host(HitlFactors, spec["hitl"], device)
        self.lr = from_host(OdomFactors, spec["lr"], device)
        self.graph = None
        if spec["pairs"] is not None:
            src, tgt = spec["pairs"]
            self.pair_span = _span(src, tgt)
            self.src = torch.as_tensor(src, device=device)
            self.tgt = torch.as_tensor(tgt, device=device)
        else:
            planar = from_host(Correspondences, spec["planar"], device)
            edge = from_host(Correspondences, spec["edge"], device)
            self.pair_span = max(_span(spec[k]["src"], spec[k]["tgt"])
                                 for k in ("planar", "edge"))
            self.graph = FactorGraph(odom=self.odom, planar=planar, edge=edge,
                                     hitl=self.hitl)

    def associate(self, x, window: int):
        """Match this rank's pairs at x for one window size."""
        spec = self.spec
        args = (self.problem, x[:spec["n"]], self.src, self.tgt, window,
                spec["outlier"])
        gate = spec["use_normal_gate"]
        self.graph = FactorGraph(
            odom=self.odom, hitl=self.hitl,
            planar=correspond.associate(*args, feature="planar",
                                        use_normal_gate=gate),
            edge=correspond.associate(*args, feature="edge",
                                      use_normal_gate=gate))

    def assemble(self, x) -> torch.Tensor:
        """The slice's normal equations at x as one flat host buffer."""
        spec = self.spec
        n = spec["n"]
        if spec["form"] == "dense":
            H, g, cost = assemble_normal_equations(x, self.graph)
            pieces = {"H": H, "g": g, "cost": cost}
        else:
            sys, cost = assemble_banded_scatter(
                x, self.graph, n, spec["w"], spec["analytic"],
                pair_span=self.pair_span)
            pieces = {"levels": torch.cat([sys.diag[None], sys.band]),
                      "g": sys.g, "C": sys.C, "E": sys.E, "gl": sys.gl}
            if "U" in self.shapes:
                first, total = spec["lr_cols"]
                U = torch.zeros((3 * n, total), dtype=x.dtype, device=x.device)
                if self.lr.count:
                    U_loc, g_lr, cost_lr = lowrank_factor_columns(x, self.lr,
                                                                  n)
                    U[:, first:first + U_loc.shape[1]] = U_loc
                    pieces["g"] = pieces["g"] + g_lr
                    cost = cost + cost_lr
                pieces["U"] = U
            pieces["cost"] = cost
        return torch.cat([pieces[k].reshape(-1)
                          for k in self.shapes]).cpu()

    def cost(self, x) -> torch.Tensor:
        return total_cost(x, self.graph).reshape(1).cpu()


def csm_slice(points, masks, src, tgt, centers, params,
              rows: int) -> torch.Tensor:
    """One rank's share of a CSM pair list through the pair engine: a flat
    float32 host buffer of ``rows`` (score, tx, ty, theta) rows, the pairs
    first, zeros after them."""
    from nautilus_tpu_torch.kernels.csm import csm_match_pairs
    out = np.zeros((rows, 4), np.float32)
    if len(src):
        scores, transforms = csm_match_pairs(points, masks, src, tgt, params,
                                             rotation_centers=centers,
                                             engine="pair")
        out[:len(src), 0] = scores
        out[:len(src), 1:] = transforms
    return torch.from_numpy(out.reshape(-1))


def launch_counts(reset: bool) -> torch.Tensor:
    """[fused_coarse, correlate] launches of this process; zeroed after the
    read when ``reset``."""
    from nautilus_tpu_torch.kernels import csm_coarse, csm_correlate
    fns = (csm_coarse.fused_coarse, csm_correlate.correlate)
    counts = torch.tensor([fn.launches for fn in fns], dtype=torch.int64)
    if reset:
        for fn in fns:
            fn.launches = 0
    return counts


class Rank:
    """The state of one rank and its command handlers.  ``serve`` returns
    what the command's collective leaves at this rank."""

    def __init__(self, pg, device):
        self.pg = pg
        self.device = torch.device(device)
        self.problem = None
        self.clouds = None
        self.slice: Optional[FactorSlice] = None
        # Reductions made and the bytes of their buffers.
        self.reductions = 0
        self.reduced_bytes = 0

    def _x(self, x):
        return torch.as_tensor(x, device=self.device)

    def reduce_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """The one reduction of a mesh: the sum over the ranks of a flat
        host buffer, left in rank 0's (the identity on a world of size 1).
        Every assembly and cost goes through it, so a machine with several
        cards can switch it to NCCL."""
        self.reductions += 1
        self.reduced_bytes += flat.numel() * flat.element_size()
        if self.pg is None:
            return flat
        opts = dist.ReduceOptions()
        opts.rootRank = 0
        opts.reduceOp = dist.ReduceOp.SUM
        self.pg.reduce([flat], opts).wait()
        return flat

    def gather(self, flat):
        return [flat] if self.pg is None else gather_to_root(self.pg, flat)

    def serve(self, cmd: str, payload):
        if cmd == "problem":
            arrays, dtype = payload
            self.problem = problem_from_numpy(arrays, self.device,
                                              getattr(torch, dtype))
        elif cmd == "clouds":
            points, masks = payload
            self.clouds = (torch.as_tensor(points, device=self.device),
                           torch.as_tensor(masks, device=self.device))
        elif cmd == "slices":
            self.slice = FactorSlice(payload, self.device, self.problem)
        elif cmd == "assemble":
            x, window = payload
            x = self._x(x)
            if window is not None:
                self.slice.associate(x, window)
            return self.reduce_sum(self.slice.assemble(x))
        elif cmd == "cost":
            return self.reduce_sum(self.slice.cost(self._x(payload)))
        elif cmd == "csm":
            return self.gather(csm_slice(*self.clouds, *payload))
        elif cmd == "launches":
            return self.gather(launch_counts(payload))
        else:
            raise ValueError(f"unknown mesh command {cmd!r}")
        return None


def main(rank: int, size: int, store_path: str, device: str, threads: int,
         conn):
    """A worker process: join the group, then serve the controller's
    commands until ``stop`` or until the controller's end of the pipe
    closes.  Any failure goes back over the pipe, and the process exits
    with code 1; the collective the controller is in then raises there."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        conn.send(("started", None))
        rank_state = Rank(make_group(store_path, rank, size), device)
        while True:
            try:
                cmd, payload = conn.recv()
            except EOFError:
                return
            if cmd == "stop":
                return
            rank_state.serve(cmd, payload)
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1)
