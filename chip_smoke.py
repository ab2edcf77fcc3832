#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nautilus_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the TF32 flags the package turns off;
2. build: compiles both CUDA kernels (kernels/csrc/csm_coarse.cu and
   csm_correlate.cu), one nvcc each, started together, with nvcc time and
   ptxas registers and spills;
3. fused coarse kernel against plain: the kernel and its plain PyTorch
   version on the same inputs at the benchmark shapes (C=8, and the main
   path's chunk of PAIR_CHUNK pairs) and at the gdc_2020 scan range, with
   max abs error, argmax agreement, CUDA-event times, and the bound
   (float32 adds; and, printed beside it, the time the adds' table reads
   take at shared memory's rate) with the kernel's share of it;
4. correlation kernel against plain: the same at the pair engine's shapes
   (reference params, bench.py's 12 m range, gdc_2020's 8.5 m range, a
   batch of PAIR_BATCH pairs) with rasters of rotated points, with the
   bound (HBM bytes) and the time of one PyTorch call that computes the
   same function, a grouped F.conv2d (cuDNN, TF32 off, cudnn.benchmark
   off and on; the port never calls it), and a table too large for shared
   memory with integer values, which must agree bit for bit;
5. small-input reference: the port's slice (solve, auto-LC, one HITL step)
   on the card against the same slice on the CPU (the CPU path is held to
   the JAX package by the tests);
6. main path: the GDC-scale synthetic (1000 poses, building world, 720
   beams, seed 1) through solve_slam -> solve_auto_lc(apply=True) ->
   write_poses, counting fused coarse kernel launches;
7. pair engine: bench.py's scan-matching leg (64 pairs (i, i+1) at the
   reference params and at 12 m, both engines, pairs/s best of 3), then the
   main path's window-expanded gated pairs through engine="pair" against
   the stage engine, counting correlation kernel launches;
8. HITL: bench.py's scripted colinearity constraint on the closed map
   through the CLI's apply_hitl_line (two solves), with poses selected per
   line, per-window costs and the HITL residual cost;
9. bag path: bench.py's GDC-scale bag (1000 poses, building world, 720
   beams, seed 1, lz4 chunks) written, checked native reader against the
   Python reader, ingested (best of 2, MB/s and msgs/s), then the CLI with
   --write --vectorize and auto_lc=true (cli.run), with each stage's wall,
   the ingest cache and a checkpoint round trip of the final session;
10. CR backend: the 5000-pose building (benchmarks/LARGE_N.md's row)
   through solve_slam, where method='auto' picks block cyclic reduction,
   then scan against CR on the final window's system at N=1000 (phase 6)
   and N=5000: CUDA-event ms, best of 5, and the steps' difference;
11. dense fallback: phase 6's input with lr_factor_cap=8, below the 27
   closures auto-LC accepts: solve_slam and the gate run on the band, the
   fused coarse kernel scores the gated pairs, and the re-solve resolves to
   the dense Cholesky route on the 3000 x 3000 system; its final cost and
   closed ATE against phase 6's Woodbury re-solve, then the dense
   covariance engine's chi-square scores on the gated pairs against the
   band engine's, with walls and the phase's peak device memory;
12. the other routes on the same input: linear_solver="dense" through
   solve_slam (per-window costs against phase 6), linear_solver="cg"
   through solve_max_window on phase 11's closed graph with the band
   preconditioner (final cost against the dense re-solve, LM steps, inner
   CG iterations), then on the same graph 'auto' resolving to CG (an
   instance's DENSE_MAX_NODES below N) and CG with the block-Jacobi
   preconditioner (one odometry factor outside the band), each against the
   dense route on the same input; solver_dtype=float64 through make_problem
   -> solve_slam -> solve_auto_lc (costs beside float32's, counts, ATE,
   fused launches);
13. the small routes at the main path's width: optimization type ALL
   through solve_slam on phase 6's input (1000 poses, 720 beams, chunks of
   64 pairs), then on a 200-pose building at 720 beams against the CPU (per
   window final costs and poses), then the same comparison on phase 6's
   input cut to windows 1-3 (the whole sweep takes minutes of CPU); Hough
   normals on phase 6's scans against the CPU and against the PCA normals;
   and the descriptor gate on phase 6's gated pairs, card against CPU;
14. the mesh (parallel/sharded.py): phase 6's path (solve_slam ->
   solve_auto_lc(apply=True)) over meshes of 1, 2 and 4 ranks, all on the
   one card, each held to phase 6 (22/49/27, final cost, closed ATE), with
   spawn and join walls, bytes reduced per LM step on the band and in a
   dense max-window solve, and the correlation kernel's launches on every
   rank; the sharded CSM batch on phase 6's gated pairs against phase 7's
   single-process pair engine; --devices 2 through the CLI, which a one-card
   machine refuses with rc 1;
15. the visualizer, the ROS command bridge and the library calls: phase 6's
   input through solve_slam with a SnapshotVisualizer (one snapshot per
   window and the initial one; final cost against phase 6's), one window
   with per_iteration_viz (a snapshot per LM step), bench.py's HITL message
   wire-encoded through RosInputBridge.dispatch on phase 8's closed map
   (per-window costs against phase 8's), /write_output and
   /vectorize_output; best_scan_match and csm_match_grouped on phase 6's
   gated pairs against the pair engine, counting correlation launches; and
   the device busy share of phase 6's solve and auto-LC, from a
   torch.profiler trace (utils/timer.profile_to) of each;
16. the trainer: the embedding's train(300 steps, seed 0) on the card and
   on the CPU (losses per step, weights, calibration), walls and steps/s,
   then phase 13's descriptor gate with the weights it wrote and read back;
17. the referee (nautilus_tpu_torch/baseline, numpy/scipy float64 on the
   host CPU, sharing no code with the solver or the kernels): phase 6's
   input solved from phase 6's x0 by the referee's growing-window
   Levenberg-Marquardt, and phase 6's band, phase 12's dense and float64
   sweeps scored under its cost (each within 1e-4 of the referee's own
   solution's, inside the JAX package's 1 % bar, where x0 and the
   referee's window-9 solution must lie outside 1e-4), with walls and ATE;
   phase 5's 32-pose HITL step on the card against the referee's
   hitl_callback (the same bars);
   the CPU scan-match twin against the stage engine (fused coarse kernel)
   and the pair engine (correlation kernel) on bench.py's 4 CPU-leg pairs
   and 8 gated pairs (scores within 2e-3, transforms within 2e-2 and the
   finest grid step), counting both kernels' launches;
18. the band scan's CUDA graphs (solve/band.py): solve_damped_banded and
   band_inverse_node_columns on phase 6's closed-map system at N=1000
   (Woodbury columns; the gate's columns of three poses), eager scans
   against graph replays, wall ms per call (median of 10), equal bit for
   bit, with the replays' share of the graph cache's calls, its captures,
   the graphs it holds and any key whose capture failed.

Each path (6 to 17) starts with every launch count at 0 and reads them
when it ends.  Exits non-zero on any failure.  The last line is one JSON object
{"ok": true, "device": {...}}; the line before it holds the card's name and
power limit, and the one before that the kernels' JSON record (launches on
their path; times, bound and library call at the main path's shapes; the
largest error over every case).
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel-vs-plain tolerance: both sum the same float32 table values, in
# another order (points in the kernel, cells x offsets in the plain bmm).
RTOL, ATOL = 1e-5, 1e-4
# Card-vs-CPU slice tolerance on poses: float32 reduction order and the
# transcendental functions' last bits differ between the two devices.
POSE_ATOL = 1e-3
# bench.py's scripted curation message on the GDC-scale building.
HITL_WIDTH = 0.3
HITL_LINES = ((-19, -15), (19, -15), (-19, -14.5), (19, -14.5))
BENCH_R05 = {"candidates": 22, "gated": 49, "accepted": 27,
             "final_cost": 92.4868, "ate_odometry": 0.3303,
             "ate_solved": 0.5621, "ate_closed": 0.1182}


# The least time one NVIDIA H100 SXM could take for a kernel's work (NVIDIA's
# data sheet, dense rates, at the full 700 W power limit): 3.35 TB/s of HBM;
# 67 TFLOP/s in float32 outside the tensor cores, which counts a fused
# multiply-add as two operations, so 33.5e12 lone adds per second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_ADDS_PER_S = F32_FLOPS_PER_S / 2
# Shared memory moves 128 bytes per clock on each of 132 SMs; 1.98 GHz is
# the card's highest SM clock.
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9


# Phase 11: the dense re-solve against phase 6's Woodbury re-solve of the
# same closures (final cost, closed ATE in m), and the chi-square scores of
# the float32 dense and band covariance engines against each other and
# against a float64 dense engine.  A score is d^T C^-1 d with C a 2 x 2
# block of the inverse of a 3000-dof float32 Hessian: at 16 poses the
# engines agree within 5e-3 (tests/test_torch_dense_lm.py), at 1000 poses
# float32 leaves percents, and float64 says which engine is off.
DENSE_COST_RTOL = 1e-4
DENSE_ATE_ATOL = 1e-3
# Each float32 engine's bar against the float64 referee, about three times
# what the H100 showed at 1000 poses (dense 3.0e-3, band 9.9e-3), and the
# two float32 engines against each other, the sum of the two.
GATE_SCORE_REL = {"dense": 1e-2, "band": 3e-2, "dense vs band": 4e-2}
# Phase 12: CG's final cost against the dense re-solve's (the bar between
# the JAX package's dense and CG sweeps, tests/test_cg.py).
CG_COST_REL = 5e-3
# The two other CG routes ('auto' past DENSE_MAX_NODES, block Jacobi) against
# the dense route on the same input.
CG_ROUTE_RTOL = 1e-3
# Phase 14: phase 6's path over meshes of these sizes on the one card, held
# to phase 6's single-process run: a sum over ranks adds in another order,
# so costs and poses are held, not iteration counts.
MESH_SIZES = (1, 2, 4)
MESH_COST_RTOL = 1e-4
MESH_ATE_ATOL = 1e-3
# Closures that phase 11 lets ride the band as Woodbury columns.
LR_CAP = 8
# Phase 13.  Optimization type ALL: the card's per-window final costs and
# poses against the CPU's on a building of ALL_CPU_POSES poses at the main
# path's beam count, all windows, and on the main path's input (1000 poses)
# through its first ALL_CPU_WINDOWS windows: a window of that input took
# 15-17 s of CPU on an H100 machine's host (8 cores), so three hold the leg
# near 50 s, inside 90 s on a host up to 1.8x slower; the whole sweep
# takes minutes of CPU where the card takes seconds.  Hough normals, card
# against CPU on the main path's scans: where the winning bin is the same
# the normals agree within HOUGH_ATOL, as
# tests/test_torch_hough.py holds the port to the JAX package; rsqrt and
# acos differ in the last bit between the devices, so a point whose two best
# bins tie or differ by one vote may change bins: HOUGH_MOVED_SHARE of the
# points may.  HOUGH_PCA_SHARE of them lie within 20 degrees of the PCA
# normal (the same test's bar).
ALL_CPU_POSES = 200
ALL_COST_RTOL = 1e-3
ALL_CPU_WINDOWS = 3
HOUGH_ATOL = 1e-4
HOUGH_MOVED_SHARE = 1e-4
HOUGH_PCA_SHARE = 0.5


# Scan against CR: the steps' largest difference relative to the scan's
# largest entry, as tests/test_torch_band_cr.py holds the two backends.
CR_STEP_REL = 2e-3
# Phase 15.  A visualizer changes no math: the visualized sweep's final cost
# against phase 6's band sweep.  The HITL message through the bridge runs
# phase 8's computation again on the same closed map: its per-window costs
# against phase 8's.  best_scan_match and csm_match_grouped run the pair
# engine's kernel on other batches: scores within LIB_SCORE_ATOL (the
# tests' bar) and transforms within the finest grid step of the pair
# engine's on the same pairs.
VIZ_COST_RTOL = 1e-4
BRIDGE_COST_RTOL = 1e-5
LIB_SCORE_ATOL = 1e-4
# Phase 16: the trainer on the card against the port's CPU trainer (which the
# tests hold to the JAX trainer within rtol 1e-5 and atol 1e-4): each step's
# loss, the final weights and the calibration scalar.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_WEIGHT_ATOL = 1e-3
TRAIN_CALIB_ATOL = 1e-3
# Phase 17, the float64 CPU referee (nautilus_tpu_torch/baseline).  A
# card solve's final cost under the referee's cost, at the final window's
# correspondences of each solution, within REFEREE_COST_REL of the
# referee's own solution's (the JAX package's bar, bench.py:398-423) and
# within REFEREE_COST_TIGHT besides; the HITL step's the same with its rows.
# The 1 % bar cannot tell a sweep that stopped a window early: the final
# window moves the cost by about 1 % (phase 6 prints each window's initial
# and final cost).  So the referee's own cost at x0 and at its solution
# after the next-to-last window are controls that must lie outside
# REFEREE_COST_TIGHT, which sits between them and the sound gaps (1e-7 and
# below on an H100).  The CPU scan-match twin against both
# engines: the JAX package's bars (tests/test_cpu_csm.py), and transforms
# within the finest grid step besides.  bench.py's CPU leg matched pairs
# (i, i+1) for the first CSM_BENCH_PAIRS; CSM_GATED_PAIRS of the main path's
# window-expanded gated pairs, evenly spaced over the list.
REFEREE_COST_REL = 1e-2
REFEREE_COST_TIGHT = 1e-4
CSM_SCORE_ATOL = 2e-3
CSM_TRANSFORM_ATOL = 2e-2
CSM_BENCH_PAIRS = 4
CSM_GATED_PAIRS = 8


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def agreement(out_k, out_p):
    """(max abs err, allclose at RTOL/ATOL, argmax equal beyond ties in
    every row, rows with equal argmax) of a kernel's output against its
    plain version's, rows along the leading dim."""
    import torch
    err = float((out_k - out_p).abs().max())
    close = bool(torch.allclose(out_k, out_p, rtol=RTOL, atol=ATOL))
    fk, fp = out_k.reshape(out_k.shape[0], -1), out_p.reshape(out_k.shape[0],
                                                              -1)
    ak, ap = fk.argmax(1), fp.argmax(1)
    rows = torch.arange(fk.shape[0], device=fk.device)
    ties = (fp[rows, ak] == fp[rows, ap]) | (fk[rows, ak] == fk[rows, ap])
    return err, close, bool(((ak == ap) | ties).all()), int((ak == ap).sum())


def _ring_points(rng, B, P, scan_range, res):
    """Scan-like points: a ring of radii in [0.5, scan_range], the first 64
    exactly on cell edges at theta = 0."""
    import numpy as np
    r = rng.uniform(0.5, scan_range, (B, P))
    a = rng.uniform(-np.pi, np.pi, (B, P))
    pts = np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)
    pts[:, :64, 0] = (np.arange(64) * res - scan_range + 3 * res)
    return pts


def coarse_inputs(dev, scan_range, C, P, seed):
    """Fused coarse stage inputs built the way the matcher builds them, with
    ~10% masked points and points on cell edges: (parked, thetas, tables,
    keyword arguments)."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.kernels import csm

    params = csm.CSMParams(scan_range=scan_range)
    res = params.low_res
    cells = params.kernel_cells(res)
    noff = 2 * params.offset_cells(res) + 1
    n_rot = int(np.ceil(2 * params.rotation_restriction / (res / scan_range)))
    rng = np.random.default_rng(seed)
    pts = _ring_points(rng, C, P, scan_range, res)
    mask = rng.random((C, P)) > 0.1
    table_pts = torch.as_tensor(pts[::-1].copy(), device=dev)
    tables, _ = csm.build_tables(table_pts, torch.ones((C, P), dtype=torch.bool,
                                                       device=dev), params)
    tables = tables.to(torch.bfloat16).to(torch.float32).contiguous()
    parked = torch.as_tensor(np.where(mask[..., None], pts, 1e6)
                             .astype(np.float32), device=dev)
    thetas = rng.uniform(-np.pi, np.pi, (C, n_rot)).astype(np.float32)
    thetas[:, 0] = 0.0
    thetas = torch.as_tensor(thetas, device=dev)
    kw = dict(cells=cells, noff=noff, halfwidth=scan_range, res=res)
    return parked, thetas, tables, kw


def bound_ms(nbytes, t_ops_ms):
    """(least ms, "bytes" or "operations"): the larger of the bytes' time at
    the HBM rate and the operations' time ``t_ops_ms``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops_ms), ("bytes" if t_bytes >= t_ops_ms
                                    else "operations")


def fused_coarse_work(parked, thetas, tables, *, cells, noff, halfwidth,
                      res):
    """Bytes and float32 adds of the fused coarse stage on these inputs (the
    points binned as its plain version bins them: one add per in-raster
    point and offset), its bound, and the time the adds' table reads (one
    4-byte word each) take at shared memory's rate."""
    import torch
    res_t = torch.tensor(res, dtype=torch.float32, device=parked.device)
    ct = torch.cos(thetas)[..., None]
    st = torch.sin(thetas)[..., None]
    x, y = parked[:, None, :, 0], parked[:, None, :, 1]
    ix = torch.floor((ct * x - st * y + halfwidth) / res_t)
    iy = torch.floor((st * x + ct * y + halfwidth) / res_t)
    inside = int(((ix >= 0) & (ix < cells) & (iy >= 0) & (iy < cells)).sum())
    C, R = thetas.shape
    adds = inside * noff * noff
    nbytes = 4 * (parked.numel() + thetas.numel() + tables.numel()
                  + C * R * noff * noff)
    ms, by = bound_ms(nbytes, adds / F32_ADDS_PER_S * 1e3)
    return {"bytes": nbytes, "adds": adds, "in_raster": inside,
            "bound_ms": ms, "bound_by": by,
            "smem_reads_ms": 4 * adds / SMEM_BYTES_PER_S * 1e3}


def correlate_work(tables, rasters):
    """Bytes and multiply-adds of the correlation of tables [B, H, W] with
    rasters [B, R, kh, kw] (one per non-zero raster cell and offset), and
    its bound."""
    B, H, W = tables.shape
    R, kh, kw = rasters.shape[1:]
    n_off = (H - kh + 1) * (W - kw + 1)
    nnz = int((rasters != 0).sum())
    nbytes = 4 * (tables.numel() + rasters.numel() + B * R * n_off)
    ms, by = bound_ms(nbytes, 2 * nnz * n_off / F32_FLOPS_PER_S * 1e3)
    return {"bytes": nbytes, "fmas": nnz * n_off, "nnz": nnz,
            "bound_ms": ms, "bound_by": by}


def kernel_case(dev, scan_range, C=8, P=768, seed=0, reps=20):
    """Fused coarse kernel vs plain on coarse_inputs: its record, with the
    kernel's call under "run"."""
    import torch
    from nautilus_tpu_torch.kernels import csm_coarse

    parked, thetas, tables, kw = coarse_inputs(dev, scan_range, C, P, seed)
    cells, noff = kw["cells"], kw["noff"]
    n_rot, T = thetas.shape[1], tables.shape[1]

    def run():
        return csm_coarse.fused_coarse(parked, thetas, tables, **kw)

    out_k = run()
    out_p = csm_coarse.fused_coarse_reference(parked, thetas, tables, **kw)
    torch.cuda.synchronize()
    err, close, argmax_ok, n_same = agreement(out_k, out_p)
    ms = cuda_ms(run, reps)
    plain_ms = cuda_ms(lambda: csm_coarse.fused_coarse_reference(
        parked, thetas, tables, **kw), 5)
    work = fused_coarse_work(parked, thetas, tables, **kw)
    print(f"  scan_range={scan_range} C={C} P={P} R={n_rot} cells={cells} "
          f"noff={noff} T={T}: max_abs_err={err!r} "
          f"allclose(rtol={RTOL},atol={ATOL})={close} "
          f"argmax_equal={n_same}/{C} kernel_ms={ms!r} plain_ms={plain_ms!r}",
          flush=True)
    print(f"    bound_ms={work['bound_ms']!r} ({work['bound_by']}: "
          f"{work['adds']} float32 adds at {F32_ADDS_PER_S!r}/s, "
          f"{work['bytes']} bytes) share_of_bound={work['bound_ms'] / ms!r}; "
          f"computed ceiling of the adds' table reads at shared memory's "
          f"rate {work['smem_reads_ms']!r} ms (share "
          f"{work['smem_reads_ms'] / ms!r}); library_ms=None (no PyTorch "
          f"call rotates, rasters and correlates)", flush=True)
    if not close:
        fail(f"kernel disagrees with plain version (max abs err {err})")
    if not argmax_ok:
        fail("kernel argmax differs from the plain version's beyond a tie")
    return {"kernel": "fused_coarse", "scan_range": scan_range, "C": C,
            "R": n_rot, "T": T, "in_raster": work["in_raster"],
            "bytes": work["bytes"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"],
            "share_of_bound": work["bound_ms"] / ms,
            "smem_reads_ms": work["smem_reads_ms"], "library_ms": None,
            "run": run}


def library_correlate_ms(tables, rasters):
    """The yardstick: one grouped F.conv2d (cuDNN) computing the same
    correlation, TF32 off, the faster of cudnn.benchmark off and on; and
    its largest difference from the plain version."""
    import torch
    import torch.nn.functional as F
    from nautilus_tpu_torch.kernels import csm_correlate
    B, H, W = tables.shape
    R, kh, kw = rasters.shape[1:]

    def call():
        return F.conv2d(tables.view(1, B, H, W),
                        rasters.view(B * R, 1, kh, kw), groups=B)

    ref = csm_correlate.correlate_reference(tables, rasters)
    times, err = {}, 0.0
    try:
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            out = call().view(B, R, H - kh + 1, W - kw + 1)
            err = max(err, float((out - ref).abs().max()))
            times[bench] = cuda_ms(call, 5)
    finally:
        torch.backends.cudnn.benchmark = False
    return min(times.values()), times[False], times[True], err


def correlate_inputs(dev, scan_range, B, seed):
    """The pair engine's correlation inputs: log tables from build_tables
    (rounded through bf16) and rasters of the rotated source points, built
    as csm._search_stage builds them: (tables, rasters)."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.kernels import csm

    params = csm.CSMParams(scan_range=scan_range)
    res = params.low_res
    cells = params.kernel_cells(res)
    n_rot = csm._coarse_rot_count(params)
    P = 768
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(_ring_points(rng, B, P, scan_range, res), device=dev)
    mask = torch.as_tensor(rng.random((B, P)) > 0.1, device=dev)
    tables, _ = csm.build_tables(pts.flip(0).contiguous(),
                                 torch.ones((B, P), dtype=torch.bool,
                                            device=dev), params)
    tables = csm._coarse_table(tables, params)
    thetas = rng.uniform(-np.pi, np.pi, (B, n_rot)).astype(np.float32)
    thetas[:, 0] = 0.0
    thetas = torch.as_tensor(thetas, device=dev)
    rot = csm._rotate(pts[:, None], thetas)
    rasters = csm._raster(rot.reshape(B * n_rot, P, 2),
                          mask[:, None].expand(B, n_rot, P)
                          .reshape(B * n_rot, P),
                          scan_range, res, cells).reshape(B, n_rot, cells,
                                                          cells)
    return tables, rasters


def correlate_case(dev, scan_range, B, seed, reps=10):
    """Correlation kernel vs plain on correlate_inputs: its record, with the
    kernel's call under "run"."""
    import torch
    from nautilus_tpu_torch.kernels import csm_correlate

    tables, rasters = correlate_inputs(dev, scan_range, B, seed)
    H, cells, n_rot = tables.shape[1], rasters.shape[2], rasters.shape[1]

    def run():
        return csm_correlate.correlate(tables, rasters)

    out_k = run()
    out_p = csm_correlate.correlate_reference(tables, rasters)
    torch.cuda.synchronize()
    err, close, argmax_ok, n_same = agreement(out_k, out_p)
    ms = cuda_ms(run, reps)
    plain_ms = cuda_ms(lambda: csm_correlate.correlate_reference(
        tables, rasters), 5)
    lib_ms, lib_off, lib_on, lib_err = library_correlate_ms(tables, rasters)
    work = correlate_work(tables, rasters)
    print(f"  scan_range={scan_range} B={B} R={n_rot} H=W={H} kh=kw={cells}: "
          f"max_abs_err={err!r} "
          f"allclose(rtol={RTOL},atol={ATOL})={close} "
          f"argmax_equal={n_same}/{B} kernel_ms={ms!r} plain_ms={plain_ms!r}",
          flush=True)
    print(f"    bound_ms={work['bound_ms']!r} ({work['bound_by']}: "
          f"{work['bytes']} bytes at {HBM_BYTES_PER_S!r}/s, "
          f"{work['fmas']} multiply-adds) "
          f"share_of_bound={work['bound_ms'] / ms!r}; library_ms={lib_ms!r} "
          f"(grouped conv2d, cudnn.benchmark off {lib_off!r} / on "
          f"{lib_on!r}, max abs diff from plain {lib_err!r})", flush=True)
    if not close:
        fail(f"correlation kernel disagrees with plain (max abs err {err})")
    if not argmax_ok:
        fail("correlation argmax differs from the plain version's beyond a "
             "tie")
    return {"kernel": "correlate", "scan_range": scan_range, "B": B,
            "R": n_rot, "H": H, "kh": cells, "nnz": work["nnz"],
            "bytes": work["bytes"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"],
            "share_of_bound": work["bound_ms"] / ms,
            "achieved_GBps": work["bytes"] / ms / 1e6, "library_ms": lib_ms,
            "library_ms_benchmark_off": lib_off,
            "library_ms_benchmark_on": lib_on, "library_max_abs_err": lib_err,
            "run": run}


def correlate_global_case(dev, B=2, H=240, R=32, cells=226, seed=3):
    """A table too large for shared memory, integer-valued: the kernel reads
    it from global memory, and every sum is exact, so kernel and plain
    agree bit for bit."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.kernels import csm, csm_correlate

    rng = np.random.default_rng(seed)
    half, res, P = cells * 0.3 / 2, 0.3, 768
    pts = torch.as_tensor(_ring_points(rng, B, P, half, res), device=dev)
    thetas = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, R))
                             .astype(np.float32), device=dev)
    rot = csm._rotate(pts[:, None], thetas)
    rasters = csm._raster(rot.reshape(B * R, P, 2),
                          torch.ones((B * R, P), dtype=torch.bool, device=dev),
                          half, res, cells).reshape(B, R, cells, cells)
    tables = torch.as_tensor(rng.integers(-8, 8, (B, H, H))
                             .astype(np.float32), device=dev)
    out_k = csm_correlate.correlate(tables, rasters)
    out_p = csm_correlate.correlate_reference(tables, rasters)
    torch.cuda.synchronize()
    smem = csm_correlate.launch_plan(tables, rasters).table_in_smem
    exact = bool(torch.equal(out_k, out_p))
    err = float((out_k - out_p).abs().max())
    print(f"  integer table H=W={H} B={B} R={R} kh=kw={cells} "
          f"table_in_smem={smem}: bit_exact={exact} max_abs_err={err!r}",
          flush=True)
    if smem:
        fail(f"an {H}x{H} table was expected not to fit shared memory")
    if not exact:
        fail("correlation kernel is not bit-exact on integer tables")
    return err


HITL_SMALL_CFG = "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n"
# The reverse-traversal box's bottom wall at y = -6, and its copy 0.3 m up
# that the return pass sees once its poses are shifted by 0.3 m.
HITL_SMALL_LINE = "-5.5 -6 5.5 -6 -5.5 -5.7 5.5 -5.7"


def small_reference(cfg_text):
    """The slice at small size on the card and on the CPU.  Returns the
    card's HITL input for phase 17: its state, the solution the step
    started from and the config."""
    import numpy as np
    from nautilus_tpu_torch.core.luaconf import load_config_text
    from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
    from nautilus_tpu_torch.kernels.csm import CSMParams
    from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
    from nautilus_tpu_torch.solve.solver import Solver

    from nautilus_tpu_torch.cli import apply_hitl_line

    cfg = load_config_text(cfg_text + HITL_SMALL_CFG)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _ = reverse_traversal_problem(3, device=dev)
        solver = Solver(state, cfg)
        solver.solve_slam()
        rep = solve_auto_lc(solver, apply=True, verbose=False,
                            csm_params=CSMParams(scan_range=10.0,
                                                 high_res=0.05))
        closed = state.solution.copy()
        # A curation step on a doubled wall: the return pass drifts 0.3 m.
        state.solution[19:, 1] += 0.3
        hitl_input = {"state": state, "x_pre": state.solution.copy(),
                      "cfg": cfg}
        apply_hitl_line(solver, HITL_SMALL_LINE.split(), verbose=False)
        c = state.hitl_constraints[0]
        out[dev] = (closed, rep.accepted, state.solution.copy(),
                    state.line_poses.copy(),
                    ([k for k, _ in c.line_a_poses],
                     [k for k, _ in c.line_b_poses]))
    sol_c, acc_c, hitl_c, line_c, sel_c = out["cpu"]
    sol_g, acc_g, hitl_g, line_g, sel_g = out["cuda"]
    diff = float(np.abs(sol_c - sol_g).max())
    print(f"  reverse traversal (32 poses): accepted cuda={acc_g} cpu={acc_c} "
          f"max |pose cuda - pose cpu|={diff!r} (atol {POSE_ATOL})",
          flush=True)
    if acc_c != acc_g:
        fail("auto-LC accepted sets differ between card and CPU")
    if not acc_g:
        fail("reverse traversal did not close")
    if not np.all(np.isfinite(sol_g)) or diff > POSE_ATOL:
        fail("card poses disagree with the CPU reference")
    diff_h = float(max(np.abs(hitl_c - hitl_g).max(),
                       np.abs(line_c - line_g).max()))
    print(f"  HITL step (doubled wall): selected line A / line B cuda="
          f"{sel_g[0]} / {sel_g[1]} cpu={sel_c[0]} / {sel_c[1]}; max |pose "
          f"cuda - pose cpu|={diff_h!r} (atol {POSE_ATOL}); line pose cuda "
          f"{line_g.tolist()} cpu {line_c.tolist()}", flush=True)
    if sel_c != sel_g:
        fail("HITL selected different poses on the card and on the CPU")
    if not sel_g[0] or not sel_g[1]:
        fail("the small HITL step selected no pose on a line")
    if not (np.all(np.isfinite(hitl_g)) and np.all(np.isfinite(line_g))) \
            or diff_h > POSE_ATOL:
        fail("card HITL poses disagree with the CPU reference")
    return hitl_input       # the card's: the loop ends on "cuda"


def bench_csm_leg(state, engines):
    """bench.py's scan-matching leg: 64 pairs (i, i+1) at the reference
    params and at 12 m, pairs/s best of 3 after a warm call."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.kernels.csm import CSMParams, csm_match_pairs

    pts, msk = state.problem.points, state.problem.points_mask
    ss = np.arange(64)
    tt = ss + 1
    rates = {}
    for label, params in (("reference", CSMParams()),
                          ("12m", CSMParams(scan_range=12.0))):
        for engine in engines:
            csm_match_pairs(pts, msk, ss, tt, params, engine=engine)
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                csm_match_pairs(pts, msk, ss, tt, params, engine=engine)
                best = min(best, time.perf_counter() - t0)
            rates[(label, engine)] = len(ss) / best
            print(f"  csm {label} engine={engine}: {len(ss) / best!r} "
                  f"pairs/s (best of 3, 64 pairs)", flush=True)
    return rates


def final_window_system(solver):
    """The damped system LM solves first at the max window, at the current
    solution: (BandedSystem, fixed mask, radius)."""
    import torch
    from nautilus_tpu_torch.solve.factors import assemble_banded_system
    x = solver._current_x()
    graph = solver.build_graph(
        x, solver.config.get_int("lidar_constraint_amount_max"),
        exclude_long_range=True)
    sys_, _ = assemble_banded_system(x, graph, solver._layout, "moments",
                                     solver._long_range_factors())
    radius = torch.tensor(solver.lm_params.initial_radius, device=x.device)
    return sys_, solver._fixed_mask(), radius


def scan_vs_cr(label, solver, system):
    """One solve_damped_banded per backend on ``system``: CUDA-event ms,
    best of 5, and the steps' largest difference relative to the scan's
    largest entry."""
    import torch
    from nautilus_tpu_torch.solve import band
    sys_, fixed, radius = system
    steps, ms = {}, {}
    for method in ("scan", "cr"):
        def call():
            return band.solve_damped_banded(sys_, fixed, radius,
                                            solver.lm_params, method=method)
        step, _, ok = call()
        if not bool(ok):
            fail(f"{label}: the {method} backend's Cholesky failed")
        steps[method] = step
        best = float("inf")
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        ms[method] = best
    rel = float((steps["cr"] - steps["scan"]).abs().max()
                / steps["scan"].abs().max())
    s, _ = band.resolve_band_plan(sys_.n, sys_.w, method="cr")
    print(f"  {label}: N={sys_.n} w={sys_.w} lines={sys_.num_lines} "
          f"Woodbury columns={sys_.rank_lr}: scan {ms['scan']!r} ms "
          f"(superblock {band.resolve_band_plan(sys_.n, sys_.w, method='scan')[0]}), "
          f"CR {ms['cr']!r} ms (superblock {s}), CUDA events best of 5; "
          f"max |step cr - step scan| / max |step scan| = {rel!r} "
          f"(tolerance {CR_STEP_REL} of max |step scan|)", flush=True)
    if not rel <= CR_STEP_REL:
        fail(f"{label}: scan and CR steps differ by {rel} relative")
    return {"n": sys_.n, "scan_ms": ms["scan"], "cr_ms": ms["cr"],
            "rel_diff": rel}


def band_graph_phase(solver, system, reps=10):
    """Phase 18: each band route on ``system`` (final_window_system's
    triple) eagerly, with band._scan replaced by the eager call, then
    through the graph cache with the tracer on.  Every graph result must
    equal the eager one bit for bit, and no capture may have failed."""
    import statistics
    from unittest import mock
    import torch
    from nautilus_tpu_torch.solve import band
    from nautilus_tpu_torch.utils import timer
    sys_, fixed, radius = system
    n = sys_.n
    dev = sys_.diag.device
    # A gate group: gauged at pose 99, the columns of poses 500-502.
    gauge = torch.repeat_interleave(
        torch.arange(n + sys_.num_lines, device=dev) == 99, 3)
    cols = torch.arange(1500, 1509, device=dev)
    calls = {
        "solve_damped_banded": lambda: band.solve_damped_banded(
            sys_, fixed, radius, solver.lm_params)[0],
        "band_inverse_node_columns": lambda: band.band_inverse_node_columns(
            sys_, gauge, cols)}
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    out = {}
    for name, call in calls.items():
        with mock.patch.object(band, "_scan", lambda fn, *a: fn(*a)):
            ref = call()
            eager = [timed(call)[1] for _ in range(reps)]
        timer.take()
        timer.tracing(True)
        try:
            graphed = [timed(call) for _ in range(reps + 1)]
        finally:
            timer.tracing(False)
        spans = [sp.name for sp in timer.take()]
        captures = spans.count("band.graph.capture")
        replays = spans.count("band.graph.replay")
        same = all(torch.equal(x.view(ints[x.dtype]), ref.view(ints[x.dtype]))
                   for x, _ in graphed)
        ms_e = statistics.median(eager) * 1e3
        ms_g = statistics.median(t for _, t in graphed[1:]) * 1e3
        print(f"  {name}: N={n} w={sys_.w} Woodbury columns={sys_.rank_lr} "
              f"lines={sys_.num_lines}: eager {ms_e!r} ms, graph {ms_g!r} ms "
              f"(median of {reps}, wall with the device drained; "
              f"{ms_e / ms_g!r}x); bitwise equal {same}; in {reps + 1} "
              f"calls {captures} captures and {replays} replays, replay "
              f"share {replays / (replays + captures)!r}", flush=True)
        if not same:
            fail(f"{name}: the graph replay differs from the eager scan")
        out[name] = {"eager_ms": ms_e, "graph_ms": ms_g,
                     "captures": captures, "replays": replays}
    cache = band._GRAPHS
    failed = sorted(str(k[1:]) for k in cache.failed)
    print(f"  graph cache: {len(cache.graphs)} graphs held (limit "
          f"{band.GRAPH_CACHE_SIZE}), failed keys {failed}", flush=True)
    if cache.failed:
        fail("a band graph capture failed; those keys ran eagerly")
    return out


def same_messages(a, b):
    """The native and the Python reader's streams carry the same messages
    in the same order (stamps to 1e-6 s: the native reader rebuilds them
    from secs and nsecs in double)."""
    import numpy as np
    if len(a) != len(b) or not a:
        return False
    for ma, mb in zip(a, b):
        m, n = ma.msg, mb.msg
        if (ma.topic != mb.topic or type(m) is not type(n)
                or abs(ma.time - mb.time) > 1e-6):
            return False
        if hasattr(m, "ranges"):
            if not (np.array_equal(m.ranges, n.ranges)
                    and (m.angle_min, m.angle_max, m.angle_increment,
                         m.range_min, m.range_max)
                    == (n.angle_min, n.angle_max, n.angle_increment,
                        n.range_min, n.range_max)):
                return False
        elif hasattr(m, "position"):
            if not (np.array_equal(m.position, n.position)
                    and np.array_equal(m.orientation, n.orientation)):
                return False
        elif (m.dr, m.dx, m.dy) != (n.dr, n.dx, n.dy):
            return False
    return True


def bag_path_phase(tmp, zero_counts, read_counts, n_bag=1000):
    """Phase 9: bench.py's GDC-scale lz4 bag through the native reader, the
    builder and the ingest cache, then the CLI (cli.run) with --write
    --vectorize and auto_lc=true, then a checkpoint round trip."""
    import contextlib
    import io
    import os
    import shutil
    import numpy as np
    import torch
    from nautilus_tpu_torch import cli
    from nautilus_tpu_torch.core.luaconf import load_config
    from nautilus_tpu_torch.ingest import cache, native
    from nautilus_tpu_torch.ingest import rosbag as rb
    from nautilus_tpu_torch.ingest.builder import process_bag_file
    from nautilus_tpu_torch.ingest.synthetic import write_synthetic_bag
    from nautilus_tpu_torch.io.checkpoint import load_state, save_state
    from nautilus_tpu_torch.io.poses import read_pose_file

    bag = tmp / "gdc_scale.bag"
    t0 = time.perf_counter()
    write_synthetic_bag(bag, num_nodes=n_bag, world_kind="building",
                        num_beams=720, seed=1, substeps=2,
                        odom_noise_trans=0.02, odom_noise_rot=0.008)
    msgs = [(m.topic, m.time, m.msg) for m in rb.read_bag(bag)]
    rb.write_bag(bag, msgs, compression="lz4")
    mb = os.path.getsize(bag) / 1e6
    print(f"  bag: {mb!r} MB, {len(msgs)} messages, lz4 chunks (written in "
          f"{time.perf_counter() - t0!r} s)")

    # The reader: native unless the system libbz2 is absent; a failed build
    # or load raises (and fails the phase) while g++ and libbz2 are there.
    has_gxx = shutil.which("g++") is not None
    has_bz2 = native.library_path() is not None
    print(f"  g++ {'present' if has_gxx else 'absent'}, libbz2 "
          f"{'present' if has_bz2 else 'absent'}", flush=True)
    try:
        reader = native.reader_name()
    except Exception as exc:    # noqa: BLE001  (reported as the failure)
        fail(f"the native bag reader did not build or load: {exc}")
    if has_gxx and has_bz2 and reader != "native":
        fail("g++ and libbz2 are present but the native reader did not run")
    if reader == "native":
        t0 = time.perf_counter()
        from_native = native.read_bag_native(bag, "/scan", "/odom")
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        from_python = list(rb.read_bag(bag, topics=["/scan", "/odom"]))
        t_python = time.perf_counter() - t0
        print(f"  native reader ({native.library_path()}): {len(from_native)} "
              f"messages in {t_native!r} s; Python reader {len(from_python)} "
              f"in {t_python!r} s")
        if not same_messages(from_native, from_python):
            fail("the native reader's messages differ from the Python "
                 "reader's on the GDC-scale bag")
    print(f"  reader: {reader}", flush=True)

    shutil.copy(ROOT / "config" / "default_config.lua", tmp)
    cfg_path = tmp / "gdc_bag.lua"
    cfg_path.write_text(
        f'dofile("default_config.lua")\nbag_path="{bag}"\n'
        f'lidar_topic="/scan"\nodom_topic="/odom"\npose_number={n_bag}\n'
        f'auto_lc=true\npose_output_file="{tmp / "poses.txt"}"\n'
        f'map_output_file="{tmp / "map.csv"}"\n')
    cfg = load_config(cfg_path)
    # bench.py's ingest leg: best of 2, the first paying the reader's build
    # and a cold page cache.
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        raw = process_bag_file(bag, cfg, verbose=False)
        dt = min(dt, time.perf_counter() - t0)
    nodes = int(raw.points.shape[0])
    print(f"  ingest (reader + builder) best of 2: {dt!r} s, {mb / dt!r} "
          f"MB/s, {len(msgs) / dt!r} msgs/s, {nodes} nodes", flush=True)
    # tests/test_e2e_bag.py's range: the motion gate drops ~30 % at most.
    if not 0.7 * n_bag <= nodes <= n_bag:
        fail(f"{nodes} nodes ingested, outside {0.7 * n_bag}-{n_bag}")

    # The ingest cache lives in this run's temp dir: the CLI's ingest is a
    # miss, and nothing is left behind.
    cache.cache_dir = lambda: tmp
    zero_counts()
    rc, solver, walls = cli.run(["--config_file", str(cfg_path), "--write",
                                 "--vectorize", "--quiet"])
    counts = read_counts()
    if rc != 0:
        fail(f"the CLI returned {rc} on the bag")
    state = solver.state
    print("  CLI walls s: " + ", ".join(f"{k} {v!r}" for k, v in walls.items()))
    print(f"  CLI: {state.num_nodes} poses, {len(state.lc_factors)} loop "
          f"closures applied; kernel launches {counts}", flush=True)
    poses = read_pose_file(tmp / "poses.txt")
    map_rows = (tmp / "map.csv").read_text().split()
    try:
        segs = np.array([r.split(",") for r in map_rows], float)
    except ValueError:
        fail("a map CSV row is not 4 numbers")
    print(f"  map: {len(map_rows)} segments")
    if state.num_nodes != nodes or not np.all(np.isfinite(state.solution)):
        fail("non-finite or miscounted poses on the bag path")
    if len(poses) != nodes or not np.all(
            np.isfinite(np.stack(list(poses.values())))):
        fail(f"the pose file has {len(poses)} rows for {nodes} nodes, or a "
             "non-finite pose")
    if not map_rows or segs.ndim != 2 or segs.shape[1] != 4 \
            or not np.all(np.isfinite(segs)):
        fail("the map CSV is empty or a row is not 4 finite floats")
    if counts["fused_coarse"] == 0:
        fail("the bag path never launched the fused coarse kernel")

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        again = cache.load_or_ingest(bag, cfg, verbose=True)
    t_hit = time.perf_counter() - t0
    print(f"  second load_or_ingest: {out.getvalue().strip()!r} in "
          f"{t_hit!r} s")
    if "ingest cache hit" not in out.getvalue() or not all(
            np.array_equal(getattr(again, k), getattr(raw, k))
            for k in raw._fields):
        fail("the second load_or_ingest missed the cache or changed the "
             "nodes")

    # Checkpoint round trip into a blank session of the same problem.
    ckpt = tmp / "session.npz"
    save_state(state, ckpt)
    blank = dataclasses.replace(
        state, solution=np.zeros_like(state.solution), lc_factors=[],
        hitl_constraints=[], line_poses=np.zeros((0, 3)))
    back = load_state(blank, ckpt)
    same_lc = len(back.lc_factors) == len(state.lc_factors) and all(
        a[:2] == b[:2] and np.array_equal(a[2], b[2]) and a[3:] == b[3:]
        for a, b in zip(back.lc_factors, state.lc_factors))
    print(f"  checkpoint: {os.path.getsize(ckpt)} bytes, "
          f"{len(back.lc_factors)} LC factors back", flush=True)
    if not (np.array_equal(back.solution, state.solution) and same_lc
            and np.array_equal(back.line_poses, state.line_poses)):
        fail("a save_state/load_state round trip changed the session")
    torch.cuda.synchronize()
    return {"mb": mb, "ingest_s": dt, "nodes": nodes, "reader": reader,
            "walls": walls, "launches": counts, "segments": len(map_rows)}


def cr_phase(cfg, dev, zero_counts, read_counts, n=5000):
    """Phase 10: the 5000-pose building through solve_slam, where
    method='auto' picks block cyclic reduction; returns the solver."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.solve import band
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    w = cfg.get_int("lidar_constraint_amount_max")
    print(f"  resolve_band_plan({n}, {w}) = {band.resolve_band_plan(n, w)}; "
          f"CR_MIN_NODES {band.CR_MIN_NODES}", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    state, gt = make_problem(n, "building", num_beams=720, seed=1,
                             odom_noise_trans=0.02, odom_noise_rot=0.008,
                             device=dev)
    torch.cuda.synchronize()
    print(f"  preprocess (synthesize + normals + features) wall "
          f"{time.perf_counter() - t0!r} s", flush=True)
    x0 = state.solution.copy()
    # Count the factorizations each backend runs during the solve.
    used = {"cr": 0, "scan": 0}
    real_cr, real_scan = band.cr_factor_tridiag, band._tridiag_cholesky

    def cr_counted(*a):
        used["cr"] += 1
        return real_cr(*a)

    def scan_counted(*a):
        used["scan"] += 1
        return real_scan(*a)

    band.cr_factor_tridiag, band._tridiag_cholesky = cr_counted, scan_counted
    solver = Solver(state, cfg)
    try:
        t0 = time.perf_counter()
        stats = solver.solve_slam()
        t_solve = time.perf_counter() - t0
    finally:
        band.cr_factor_tridiag, band._tridiag_cholesky = real_cr, real_scan
    sol = state.solution
    print(f"  solve_slam wall {t_solve!r} s; band factorizations {used}; per "
          "window (window, iterations, initial cost, final cost, wall s):")
    print_windows(stats)
    print(f"  ATE m: odometry {ate(x0, gt)['trans_rmse']!r} solved "
          f"{ate(sol, gt)['trans_rmse']!r}; kernel launches {read_counts()}",
          flush=True)
    if sol.shape != (n, 3) or not np.all(np.isfinite(sol)):
        fail("non-finite or mis-shaped poses after the 5000-pose solve")
    for st in stats.windows:
        if st.final_cost > st.initial_cost:
            fail(f"window {st.window}: final cost {st.final_cost} exceeds "
                 f"the initial {st.initial_cost}")
    if used["cr"] == 0 or used["scan"] != 0:
        fail(f"the 5000-pose solve did not run on cyclic reduction alone "
             f"({used})")
    return solver


def fresh_state(state, solution):
    """``state``'s problem at ``solution`` with no closure and no HITL
    constraint, on the ingest-time odometry."""
    import numpy as np
    return dataclasses.replace(
        state, solution=solution.copy(), lc_factors=[], hitl_constraints=[],
        line_poses=np.zeros((0, 3)),
        odometry_factors=state.initial_odometry_factors)


def timed(fn):
    """(result, wall seconds) of fn() with the device drained on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn):
    """(result, wall seconds, {root span: seconds}) of timed(fn) with the
    port's tracer on (utils/timer); auto-LC's root spans are its four
    stages, lc.candidates, lc.gate, lc.csm and lc.resolve."""
    from nautilus_tpu_torch.utils import timer
    timer.tracing(True)
    try:
        out, wall = timed(fn)
    finally:
        timer.tracing(False)
    stages = {}
    for sp in timer.take():
        if sp.parent < 0:
            stages[sp.name] = stages.get(sp.name, 0.0) \
                + (sp.t1_ns - sp.t0_ns) * 1e-9
    return out, wall, stages


def print_windows(stats):
    for w in stats.windows:
        print(f"    {w.window} {w.iterations} {w.initial_cost!r} "
              f"{w.final_cost!r} {w.wall_s!r}")


def dense_fallback_phase(cfg, state, x0, gt, phase6, zero_counts,
                         read_counts):
    """Phase 11.  phase6: dict with the main path's report (which holds
    its re-solve's stats), closed ATE and odometry ATE.  Returns what phase 12 builds on."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.loop_closure.matcher import (
        CHI_SQUARE_THRESHOLD, LCMatcher)
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    cfg11 = cfg.replace(lr_factor_cap=LR_CAP)
    st = fresh_state(state, x0)
    solver = Solver(st, cfg11)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats, t_solve = timed(solver.solve_slam)
    solved_with = solver.last_solver
    x_solved = st.solution.copy()
    report, t_lc, stages = traced(lambda: auto_lc.solve_auto_lc(
        solver, apply=True, verbose=False))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = (len(report.candidates), len(report.gated_pairs),
         len(report.accepted))
    ref = phase6["report"]
    n_ref = (len(ref.candidates), len(ref.gated_pairs), len(ref.accepted))
    ate_closed = ate(st.solution, gt)["trans_rmse"]
    print(f"  lr_factor_cap={LR_CAP}: solve_slam on {solved_with!r} wall "
          f"{t_solve!r} s, final cost {stats.final_cost!r}; auto-LC wall "
          f"{t_lc!r} s, stages {stages}")
    print(f"  candidates/gated/accepted {n[0]}/{n[1]}/{n[2]} (phase 6: "
          f"{n_ref[0]}/{n_ref[1]}/{n_ref[2]}); re-solve resolved to "
          f"{solver.last_solver!r} on a {3 * st.num_nodes} x "
          f"{3 * st.num_nodes} system; kernel launches {counts}")
    if report.resolve_stats is None:
        fail("auto-LC applied no closure in the dense-fallback phase")
    dense = report.resolve_stats.windows[0]
    band = phase6["report"].resolve_stats.windows[0]
    print(f"  re-solve at window {dense.window}: dense {dense.iterations} LM "
          f"steps, cost {dense.initial_cost!r} -> {dense.final_cost!r}, wall "
          f"{dense.wall_s!r} s; phase 6's band + Woodbury re-solve "
          f"{band.iterations} LM steps, cost {band.initial_cost!r} -> "
          f"{band.final_cost!r}, wall {band.wall_s!r} s")
    print(f"  closed ATE m: dense {ate_closed!r}, phase 6 "
          f"{phase6['ate_closed']!r} (odometry {phase6['ate_odom']!r}); "
          f"peak device memory in this phase {peak!r} GiB", flush=True)
    if solved_with != "band":
        fail(f"the solve before any closure ran on {solved_with!r}, not band")
    if solver.last_solver != "dense":
        fail(f"the re-solve past the closure cap ran on "
             f"{solver.last_solver!r}, not dense")
    if counts["fused_coarse"] == 0:
        fail("the dense-fallback path never launched the fused coarse kernel")
    if n != n_ref:
        fail(f"candidates/gated/accepted {n} differ from phase 6's {n_ref}")
    if not np.all(np.isfinite(st.solution)):
        fail("non-finite poses after the dense re-solve")
    if abs(dense.final_cost - band.final_cost) \
            > DENSE_COST_RTOL * band.final_cost:
        fail(f"dense re-solve cost {dense.final_cost} differs from the "
             f"Woodbury re-solve's {band.final_cost} by more than rtol "
             f"{DENSE_COST_RTOL}")
    if not ate_closed < phase6["ate_odom"] \
            or abs(ate_closed - phase6["ate_closed"]) > DENSE_ATE_ATOL:
        fail(f"dense closed ATE {ate_closed} is not below odometry's or not "
             f"within {DENSE_ATE_ATOL} m of phase 6's {phase6['ate_closed']}")

    # The gate's two covariance engines on the closed state: past the cap
    # from_solver takes the dense Cholesky, under the default cap the band
    # with 3 Woodbury columns per closure.  A float64 dense engine on the
    # same state referees the two float32 ones.
    pairs = list(report.gated_pairs)
    as64 = {f: getattr(st.problem, f).double()
            for f in ("points", "normals", "initial_poses", "odom_trans",
                      "odom_rot")}
    st64 = dataclasses.replace(st, problem=st.problem._replace(**as64))
    engines = {"dense": solver, "band": Solver(st, cfg),
               "float64": Solver(st64, cfg11)}
    scores, walls = {}, {}
    for name, sv in engines.items():
        matcher, t_build = timed(lambda: LCMatcher.from_solver(sv))
        if (matcher.H is not None) != (name != "band"):
            fail(f"LCMatcher.from_solver took the wrong engine for {name}")
        out, t_score = timed(lambda: matcher._scores(pairs))
        scores[name] = np.array([sc for _, sc in out])
        walls[name] = (t_build, t_score)
        if not np.all(np.isfinite(scores[name])):
            fail(f"a covariance factorization failed on the closed map "
                 f"({name} engine: non-finite chi-square score)")
    groups = len({max(min(s, t) - 1, 0) for s, t in pairs})

    def rel(a, b):
        d = np.abs(scores[a] - scores[b]) / np.abs(scores[b])
        return float(d.max()), pairs[int(d.argmax())]

    (r_db, p_db), (r_d, p_d), (r_b, p_b) = (
        rel("dense", "band"), rel("dense", "float64"), rel("band", "float64"))
    print(f"  gate on the closed map, {len(pairs)} pairs in {groups} gauge "
          f"groups: dense engine build {walls['dense'][0]!r} s + scores "
          f"{walls['dense'][1]!r} s, band engine build {walls['band'][0]!r} "
          f"s + scores {walls['band'][1]!r} s (float64 dense referee "
          f"{walls['float64'][0]!r} + {walls['float64'][1]!r} s)")
    f64 = scores["float64"]
    k_near = int(np.abs(f64 - CHI_SQUARE_THRESHOLD).argmin())
    print(f"  max relative chi-square difference: dense vs float64 {r_d!r} "
          f"(pair {p_d}, tolerance {GATE_SCORE_REL['dense']}), band vs "
          f"float64 {r_b!r} (pair {p_b}, tolerance "
          f"{GATE_SCORE_REL['band']}), dense vs band {r_db!r} (pair {p_db}, "
          f"tolerance {GATE_SCORE_REL['dense vs band']}); float64 scores "
          f"span {float(f64.min())!r} to {float(f64.max())!r}")
    print(f"  score nearest the chi-square threshold "
          f"{CHI_SQUARE_THRESHOLD}: pair {pairs[k_near]}, float64 "
          f"{float(f64[k_near])!r}, dense {float(scores['dense'][k_near])!r}, "
          f"band {float(scores['band'][k_near])!r}; margin "
          f"{abs(float(f64[k_near]) - CHI_SQUARE_THRESHOLD) / CHI_SQUARE_THRESHOLD!r}"
          f" of the threshold", flush=True)
    for name, r in (("dense", r_d), ("band", r_b), ("dense vs band", r_db)):
        if r > GATE_SCORE_REL[name]:
            fail(f"chi-square scores, {name}: relative difference {r} "
                 f"exceeds {GATE_SCORE_REL[name]}")
    passes = {k: v < CHI_SQUARE_THRESHOLD for k, v in scores.items()}
    if not (np.array_equal(passes["dense"], passes["float64"])
            and np.array_equal(passes["band"], passes["float64"])):
        fail("the covariance engines disagree on which pairs pass the "
             "chi-square threshold")
    return {"x_solved": x_solved, "lc_factors": list(st.lc_factors),
            "dense_resolve": dense, "cfg": cfg11, "launches": counts}


def other_routes_phase(cfg, state, x0, gt, stats6, phase11, dev, zero_counts,
                       read_counts, n=1000, beams=720):
    """Phase 12: whole solves on dense, CG and float64 (n and beams are the
    main path's input, which the float64 run builds again).  Returns the
    float64 run's fused launches and, for phase 17, the dense and float64
    sweeps' solutions before auto-LC with their walls."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    # -- dense, the whole growing-window sweep --------------------------------
    zero_counts()
    st = fresh_state(state, x0)
    solver = Solver(st, cfg, linear_solver="dense")
    stats, wall = timed(solver.solve_slam)
    # Phase 17 scores each route's solve under the float64 referee's cost.
    solves = {"dense": (st.solution.copy(), wall)}
    print(f"  linear_solver='dense' solve_slam wall {wall!r} s (phase 6 on "
          f"the band {stats6.total_wall_s!r} s); per window (window, "
          "iterations, initial cost, final cost, wall s), then phase 6's "
          "final cost:")
    for w, w6 in zip(stats.windows, stats6.windows):
        print(f"    {w.window} {w.iterations} {w.initial_cost!r} "
              f"{w.final_cost!r} {w.wall_s!r} | {w6.final_cost!r}")
    if solver.last_solver != "dense":
        fail(f"linear_solver='dense' ran on {solver.last_solver!r}")
    if not np.all(np.isfinite(st.solution)):
        fail("non-finite poses after the dense sweep")
    if abs(stats.final_cost - stats6.final_cost) \
            > DENSE_COST_RTOL * stats6.final_cost:
        fail(f"dense sweep final cost {stats.final_cost} differs from the "
             f"band sweep's {stats6.final_cost} by more than rtol "
             f"{DENSE_COST_RTOL}")

    # -- CG on phase 11's closed graph, from the point its re-solve began ----
    st = fresh_state(state, phase11["x_solved"])
    st.lc_factors = list(phase11["lc_factors"])
    solver = Solver(st, phase11["cfg"], linear_solver="cg")
    stats, wall = timed(solver.solve_max_window)
    w, dense = stats.windows[0], phase11["dense_resolve"]
    inner = w.inner_iterations
    precond = "band" if solver._odom_within_band() else "block Jacobi"
    print(f"  linear_solver='cg' solve_max_window on the closed graph "
          f"({len(st.lc_factors)} closures, {precond} preconditioner): wall "
          f"{wall!r} s, {w.iterations} LM steps, {inner} inner CG "
          f"iterations, cost {w.initial_cost!r} -> "
          f"{w.final_cost!r}; dense re-solve {dense.final_cost!r} in "
          f"{dense.wall_s!r} s; {wall / max(inner, 1)!r} s per inner "
          f"iteration, the LM steps' own work included", flush=True)
    if inner == 0:
        fail("the CG solve reports no inner iteration")
    if solver.last_solver != "cg" or precond != "band":
        fail("the CG route did not run with the band preconditioner")
    if not np.all(np.isfinite(st.solution)):
        fail("non-finite poses after the CG solve")
    if abs(w.final_cost - dense.final_cost) > CG_COST_REL * dense.final_cost:
        fail(f"CG final cost {w.final_cost} differs from the dense "
             f"re-solve's {dense.final_cost} by more than {CG_COST_REL}")
    print(f"  kernel launches on the dense and CG routes: {read_counts()}")
    cg_routes_on_the_closed_graph(state, phase11)

    # -- float64, from make_problem to the closed map --------------------------
    zero_counts()
    (st, _), t_pre = timed(lambda: make_problem(
        n, "building", num_beams=beams, seed=1, odom_noise_trans=0.02,
        odom_noise_rot=0.008, device=dev, dtype=torch.float64))
    if st.problem.points.dtype != torch.float64:
        fail("make_problem(dtype=float64) built a float32 problem")
    solver = Solver(st, cfg)
    stats, t_solve = timed(solver.solve_slam)
    solves["float64"] = (st.solution.copy(), t_solve)
    report, t_lc, stages = traced(lambda: auto_lc.solve_auto_lc(
        solver, apply=True, verbose=False))
    counts = read_counts()
    n = (len(report.candidates), len(report.gated_pairs),
         len(report.accepted))
    ate_closed = ate(st.solution, gt)["trans_rmse"]
    print(f"  solver_dtype=float64: preprocess {t_pre!r} s, solve_slam "
          f"{t_solve!r} s (float32 {stats6.total_wall_s!r} s), auto-LC "
          f"{t_lc!r} s, stages {stages}")
    print("  per window (window, iterations, float64 final cost | float32 "
          "final cost):")
    for w, w6 in zip(stats.windows, stats6.windows):
        print(f"    {w.window} {w.iterations} {w.final_cost!r} | "
              f"{w6.final_cost!r}")
    print(f"  float64 candidates/gated/accepted {n[0]}/{n[1]}/{n[2]} "
          f"(float32: 22/49/27; the gate reads a covariance, so a pair near "
          f"the chi-square threshold may change sides); re-solve final cost "
          f"{getattr(report.resolve_stats, 'final_cost', None)!r}; closed ATE "
          f"{ate_closed!r} m; kernel launches from the float64 problem "
          f"{counts}", flush=True)
    if not np.all(np.isfinite(st.solution)) or not report.applied:
        fail("the float64 path gave non-finite poses or applied no closure")
    if counts["fused_coarse"] == 0:
        fail("the float64 problem never launched the fused coarse kernel")
    # Float32 holds the final cost to ~1e-6 of float64's; 1e-4 is the bar
    # the port's float32 solve is held to against the JAX package.
    if abs(stats.final_cost - stats6.final_cost) \
            > DENSE_COST_RTOL * stats6.final_cost:
        fail(f"float64 final cost {stats.final_cost} is not within rtol "
             f"{DENSE_COST_RTOL} of float32's {stats6.final_cost}")
    if not ate_closed < ate(x0, gt)["trans_rmse"]:
        fail("float64 closed ATE is not below odometry's")
    return {"fused_launches_f64": counts["fused_coarse"], "solves": solves}


def cg_routes_on_the_closed_graph(state, phase11):
    """Phase 12's two other CG routes on phase 11's closed graph, from the
    point its re-solve began, each against the dense route on the same
    input: 'auto' past the closure cap on an instance whose DENSE_MAX_NODES
    is below N (the route 'auto' takes past 8000 poses), and CG with the
    block-Jacobi preconditioner, which one odometry factor outside the band
    selects."""
    import numpy as np
    from nautilus_tpu_torch.solve.solver import Solver

    def closed(extra_odometry=None):
        st = fresh_state(state, phase11["x_solved"])
        st.lc_factors = list(phase11["lc_factors"])
        if extra_odometry is not None:
            a, b = extra_odometry
            i, j, trans, rot = st.odometry_factors
            rel = st.solution[b] - st.solution[a]
            st.odometry_factors = (
                np.append(i, a), np.append(j, b), np.vstack([trans, rel[:2]]),
                np.append(rot, np.arctan2(np.sin(rel[2]), np.cos(rel[2]))))
        return st

    n = state.num_nodes
    far = (n // 10, n // 2)
    dense_far, wall_far = timed(
        Solver(closed(far), phase11["cfg"], linear_solver="dense"
               ).solve_max_window)
    auto = Solver(closed(), phase11["cfg"])
    auto.DENSE_MAX_NODES = n - 1
    jacobi = Solver(closed(far), phase11["cfg"], linear_solver="cg")
    routes = [("'auto' with DENSE_MAX_NODES < N", auto, "band",
               phase11["dense_resolve"], None),
              (f"'cg' with odometry factor {far} outside the band", jacobi,
               "block Jacobi", dense_far.windows[0], wall_far)]
    for name, solver, want_precond, dense, dense_wall in routes:
        stats, wall = timed(solver.solve_max_window)
        precond = "band" if solver._odom_within_band() else "block Jacobi"
        print(f"  {name}: resolved to {solver.last_solver!r}, {precond} "
              f"preconditioner, wall {wall!r} s; per window (window, LM "
              f"steps, inner CG iterations, initial cost, final cost | "
              f"dense on the same input):")
        for w in stats.windows:
            print(f"    {w.window} {w.iterations} {w.inner_iterations} "
                  f"{w.initial_cost!r} {w.final_cost!r} | "
                  f"{dense.final_cost!r}")
        print(f"    dense on the same input: wall "
              f"{dense.wall_s if dense_wall is None else dense_wall!r} s",
              flush=True)
        if solver.last_solver != "cg" or precond != want_precond:
            fail(f"{name} ran on {solver.last_solver!r} with the {precond} "
                 f"preconditioner, not CG with the {want_precond} one")
        if not np.all(np.isfinite(solver.state.solution)):
            fail(f"non-finite poses after {name}")
        if abs(stats.final_cost - dense.final_cost) \
                > CG_ROUTE_RTOL * dense.final_cost:
            fail(f"{name}: final cost {stats.final_cost} differs from the "
                 f"dense route's {dense.final_cost} by more than rtol "
                 f"{CG_ROUTE_RTOL}")


def on_cpu(state):
    """``state`` with its problem's tensors copied to the CPU and its own
    host arrays."""
    from nautilus_tpu_torch.core.problem import SLAMProblem
    return dataclasses.replace(
        state, solution=state.solution.copy(), lc_factors=[],
        hitl_constraints=[],
        problem=SLAMProblem(*[t.cpu() for t in state.problem]))


def all_route_phase(cfg, dev, state, x0, n_cpu=ALL_CPU_POSES, beams=720):
    """Phase 13, optimization type ALL: the main path's input (every pose,
    every beam) on the card; a building of ``n_cpu`` poses at the same beam
    count on the card against the CPU, all windows; then the main path's
    input on the card against the CPU through its first ALL_CPU_WINDOWS
    windows."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.solve.solver import Solver

    def sweep(st, c=cfg):
        solver = Solver(st, c)
        stats, wall = timed(lambda: solver.solve_slam(optimization_type="all"))
        if not np.all(np.isfinite(st.solution)):
            fail("non-finite poses after the ALL-type solve")
        return solver, stats, wall

    def describe(st, solver, stats, wall, where):
        q = len(solver.pairs.src)
        print(f"  optimization_type='all' on {where}: {st.num_nodes} poses, "
              f"P={st.problem.points.shape[1]}, {q} pairs in "
              f"{-(-q // 64)} chunks of 64 per association, "
              f"{len(stats.windows)} associations: solve_slam wall {wall!r} s "
              f"on {solver.last_solver!r}", flush=True)

    def card_against_cpu(st_card, c=cfg):
        """The same sweep on the card and on the CPU, held per window."""
        st_cpu = on_cpu(st_card)
        sv, card, wall = sweep(st_card, c)
        describe(st_card, sv, card, wall, "the card")
        t0 = time.perf_counter()
        sv_cpu, cpu, _ = sweep(st_cpu, c)
        describe(st_cpu, sv_cpu, cpu, time.perf_counter() - t0, "the CPU")
        d_pose = float(np.abs(st_card.solution - st_cpu.solution).max())
        print(f"  per window (window, card iterations, card final cost | CPU "
              f"iterations, CPU final cost, CPU wall s), tolerance rtol "
              f"{ALL_COST_RTOL}; max |d pose| {d_pose!r} (tolerance "
              f"{POSE_ATOL}):")
        for w, c_ in zip(card.windows, cpu.windows):
            print(f"    {w.window} {w.iterations} {w.final_cost!r} | "
                  f"{c_.iterations} {c_.final_cost!r} {c_.wall_s!r}")
        if len(card.windows) != len(cpu.windows):
            fail("the card and the CPU swept different windows")
        for w, c_ in zip(card.windows, cpu.windows):
            if abs(w.final_cost - c_.final_cost) \
                    > ALL_COST_RTOL * c_.final_cost:
                fail(f"ALL-type window {w.window}: final cost on the card "
                     f"{w.final_cost} differs from the CPU's {c_.final_cost} "
                     f"by more than rtol {ALL_COST_RTOL}")
        if d_pose > POSE_ATOL:
            fail(f"ALL-type poses on the card differ from the CPU's by "
                 f"{d_pose}")
        return cpu

    st = fresh_state(state, x0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver, stats, wall = sweep(st)
    describe(st, solver, stats, wall, "the card, the main path's input")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak!r} GiB; per window "
          "(window, iterations, initial cost, final cost, wall s):")
    print_windows(stats)
    for w in stats.windows:
        if w.final_cost > w.initial_cost:
            fail(f"ALL-type window {w.window}: final cost {w.final_cost} "
                 f"exceeds the initial {w.initial_cost}")

    st_card, _ = make_problem(n_cpu, "building", num_beams=beams, seed=1,
                              odom_noise_trans=0.02, odom_noise_rot=0.008,
                              device=dev)
    small = card_against_cpu(st_card)

    # The main path's input itself on the CPU, cut to its first windows.
    k = ALL_CPU_WINDOWS
    print(f"  the main path's input ({state.num_nodes} poses) card against "
          f"CPU, cut to windows 1-{k} of {len(small.windows)} "
          f"(lidar_constraint_amount_max={k}) to hold this leg near 50 s of "
          f"CPU: the whole sweep would take minutes (the {n_cpu}-pose one "
          f"just took {small.windows[-1].wall_s!r} s for its last window "
          f"alone)", flush=True)
    card_against_cpu(fresh_state(state, x0),
                     cfg.replace(lidar_constraint_amount_max=k))


def hough_phase(state):
    """Phase 13, Hough normals: every scan of the main path's input on the
    card against the same scans on the CPU, and against the PCA normals."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.core import preprocess as pre

    pts, msk = state.problem.points, state.problem.points_mask
    params = pre.NormalParams(method="hough")
    hough, t_hough = timed(lambda: pre.compute_normals(pts, msk, params))
    pca, t_pca = timed(lambda: pre.compute_normals(pts, msk,
                                                   pre.NormalParams()))
    t0 = time.perf_counter()
    ref = pre.compute_normals(pts.cpu(), msk.cpu(), params)
    t_cpu = time.perf_counter() - t0
    err = (hough.cpu() - ref).abs().amax(dim=-1)[msk.cpu()]
    moved = int((err > HOUGH_ATOL).sum())
    cos = torch.abs(torch.sum(hough * pca, dim=-1))[msk]
    share = float((cos > np.cos(np.deg2rad(20.0))).float().mean())
    unit = float((torch.linalg.vector_norm(hough, dim=-1)[msk] - 1).abs()
                 .max())
    print(f"  Hough normals on {tuple(pts.shape[:2])} scans x points "
          f"({err.numel()} valid): card {t_hough!r} s, CPU {t_cpu!r} s (PCA "
          f"on the card {t_pca!r} s); card against CPU: {moved} points "
          f"beyond {HOUGH_ATOL} ({int((err > 1e-2).sum())} of them beyond "
          f"1e-2: a changed bin; at most {HOUGH_MOVED_SHARE} of the points "
          f"may), largest difference among the others "
          f"{float(err[err <= HOUGH_ATOL].max())!r}; share of points within "
          f"20 degrees of the PCA normal {share!r} (at least "
          f"{HOUGH_PCA_SHARE}); max | |n| - 1 | {unit!r}", flush=True)
    if not bool(torch.isfinite(hough).all()) or unit > 1e-5:
        fail("Hough normals are not finite unit vectors")
    if bool((hough[~msk] != 0).any()):
        fail("Hough normals of masked points are not zero")
    if moved > HOUGH_MOVED_SHARE * err.numel():
        fail(f"{moved} of {err.numel()} Hough normals on the card differ "
             f"from the CPU's by more than {HOUGH_ATOL}")
    if share < HOUGH_PCA_SHARE:
        fail(f"only {share} of the Hough normals lie within 20 degrees of "
             f"the PCA normals")


def descriptor_gate_phase(cfg, state_at_gate, gated_pairs, read_counts):
    """Phase 13, the descriptor gate on the main path's gated pairs, card
    against CPU, then through solve_auto_lc's branch."""
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.solve.solver import Solver

    threshold = float(cfg.get("lc_match_threshold", 0.5))
    kept, choice, t_gate = {}, {}, {}
    for name, s in (("cuda", state_at_gate), ("cpu", on_cpu(state_at_gate))):
        t0 = time.perf_counter()
        kept[name] = auto_lc.descriptor_gate(s, gated_pairs, threshold, None)
        t_gate[name] = time.perf_counter() - t0
        choice[name] = s._descriptor_gate_choice
    c = choice["cuda"]
    print(f"  descriptor gate (lc_match_threshold={threshold}) on "
          f"{len(gated_pairs)} gated pairs: self-check picked "
          f"{c['scorer']!r} (AUC embedding {c['auc_emb']!r}, hand "
          f"{c['auc_hand']!r}; on the CPU {choice['cpu']}), kept "
          f"{len(kept['cuda'])} on the card in {t_gate['cuda']!r} s, "
          f"{len(kept['cpu'])} on the CPU in {t_gate['cpu']!r} s")
    if c["scorer"] != choice["cpu"]["scorer"] or kept["cuda"] != kept["cpu"]:
        fail("the descriptor gate chose another scorer or kept another set "
             "on the card than on the CPU")
    solver = Solver(state_at_gate, cfg)
    rep, wall = timed(lambda: auto_lc.solve_auto_lc(
        solver, apply=False, verbose=False, use_descriptor_gate=True))
    print(f"  solve_auto_lc(use_descriptor_gate=True, apply=False): "
          f"{len(rep.gated_pairs)} pairs to CSM, {len(rep.accepted)} above "
          f"the score threshold, wall {wall!r} s; kernel launches "
          f"{read_counts()}", flush=True)
    if rep.gated_pairs != kept["cuda"]:
        fail("solve_auto_lc's descriptor gate kept another set than "
             "descriptor_gate on the same pairs")
    return kept["cuda"], c["scorer"]


def sharded_phase(cfg, dev, state, x0, gt, phase6, at_gate, pair_result,
                  zero_counts):
    """Phase 14: phase 6's path over meshes of MESH_SIZES ranks on the one
    card, each held to phase 6's single-process run; the sharded CSM batch
    against phase 7's single-process pair engine on the same gated pairs;
    a dense max-window solve over the mesh for its reduction's size; and
    --devices 2 through the CLI, which a one-card machine refuses.
    Returns each mesh size's correlate launches per rank."""
    import contextlib
    import io
    import numpy as np
    import torch
    from nautilus_tpu_torch import cli
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.parallel.sharded import default_mesh
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    stats6, report6 = phase6["stats"], phase6["report"]
    n_ref = (len(report6.candidates), len(report6.gated_pairs),
             len(report6.accepted))
    params = auto_lc._csm_params_from_config(cfg)
    match_w = int(cfg.get("lc_match_window_size", 0))
    s_pr, tr_pr, best_pr = pair_result
    per_rank = {}
    for size in MESH_SIZES:
        zero_counts()
        mesh, t_spawn = timed(lambda: default_mesh(size, dev))
        try:
            mesh.launches(reset=True)
            traffic = [(mesh.rank.reductions, mesh.rank.reduced_bytes)]

            def mark():
                """(reductions, bytes reduced) since the last mark."""
                traffic.append((mesh.rank.reductions, mesh.rank.reduced_bytes))
                a, b = traffic[-2], traffic[-1]
                return b[0] - a[0], b[1] - a[1]

            st = fresh_state(state, x0)
            solver = Solver(st, cfg, mesh=mesh)
            stats, t_sweep = timed(solver.solve_slam)
            sweep_red = mark()
            x_solved = st.solution.copy()
            report, t_lc, stages = traced(lambda: auto_lc.solve_auto_lc(
                solver, apply=True, verbose=False))
            resolve_red = mark()
            launches = [c["correlate"] for c in mesh.launches(reset=True)]
            ate_closed = ate(st.solution, gt)["trans_rmse"]
            (scores, transforms, best, n_exp), t_csm = timed(
                lambda: auto_lc.match_gated_pairs(
                    at_gate, report6.gated_pairs, params, match_w, mesh=mesh))
            csm_launches = [c["correlate"] for c in mesh.launches(reset=True)]
            mark()
            dense_st = fresh_state(state, x_solved)
            dense_st.lc_factors = list(st.lc_factors)
            dense = Solver(dense_st, cfg, linear_solver="dense", mesh=mesh)
            dense_stats, t_dense = timed(dense.solve_max_window)
            dense_red = mark()
        finally:
            _, t_join = timed(mesh.close)
        n = (len(report.candidates), len(report.gated_pairs),
             len(report.accepted))
        resolve = report.resolve_stats.windows[0]
        print(f"  mesh of {size} rank(s) on {dev}: spawn and group join "
              f"{t_spawn!r} s, stop and join the workers {t_join!r} s; "
              f"solve_slam on "
              f"{solver.last_solver!r} wall {t_sweep!r} s, final cost "
              f"{stats.final_cost!r} (one process {stats6.final_cost!r}); "
              f"auto-LC wall {t_lc!r} s, stages {stages}, engine "
              f"{report.csm_engine!r}; re-solve {resolve.iterations} LM steps "
              f"{resolve.wall_s!r} s")
        print(f"    candidates/gated/accepted {n[0]}/{n[1]}/{n[2]} (one "
              f"process {n_ref[0]}/{n_ref[1]}/{n_ref[2]}); closed ATE "
              f"{ate_closed!r} m (one process {phase6['ate_closed']!r}); "
              f"correlate launches per rank in auto-LC {launches}")
        steps = {"sweep": sum(w.iterations for w in stats.windows),
                 "resolve": resolve.iterations,
                 "dense": dense_stats.windows[0].iterations}
        print("    reductions, bytes reduced and bytes per LM step: "
              + "; ".join(
                  f"{name} {k} reductions, {b} B, {b / max(steps[key], 1)!r} "
                  f"B per LM step ({steps[key]} LM steps)"
                  for name, key, (k, b) in (
                      ("sweep on the band", "sweep", sweep_red),
                      ("auto-LC with the Woodbury re-solve", "resolve",
                       resolve_red),
                      ("dense max-window solve", "dense", dense_red)))
              + f"; x sent to each worker per command "
                f"{3 * state.num_nodes * 4} B")
        print(f"    dense max-window solve over the mesh: {t_dense!r} s, "
              f"final cost {dense_stats.final_cost!r} against the Woodbury "
              f"re-solve's {resolve.final_cost!r}")
        d_score = float(np.abs(scores - s_pr).max())
        d_tr = float(np.abs(transforms - tr_pr).max())
        print(f"    sharded CSM batch on phase 6's {len(scores)} gated pairs "
              f"({n_exp} window-expanded) in {t_csm!r} s, correlate launches "
              f"per rank {csm_launches}: max |d score| {d_score!r}, max |d "
              f"transform| {d_tr!r} against one process's pair engine; best "
              f"targets equal {np.array_equal(best, best_pr)}", flush=True)
        if n != n_ref:
            fail(f"mesh of {size}: candidates/gated/accepted {n} differ from "
                 f"one process's {n_ref}")
        if report.csm_engine != "sharded pair" or solver.last_solver != "band":
            fail(f"mesh of {size}: auto-LC matched on {report.csm_engine!r}, "
                 f"the solve ran on {solver.last_solver!r}")
        if not np.all(np.isfinite(st.solution)):
            fail(f"mesh of {size}: non-finite poses")
        if abs(stats.final_cost - stats6.final_cost) \
                > MESH_COST_RTOL * stats6.final_cost:
            fail(f"mesh of {size}: final cost {stats.final_cost} not within "
                 f"rtol {MESH_COST_RTOL} of one process's {stats6.final_cost}")
        if abs(ate_closed - phase6["ate_closed"]) > MESH_ATE_ATOL:
            fail(f"mesh of {size}: closed ATE {ate_closed} not within "
                 f"{MESH_ATE_ATOL} m of one process's {phase6['ate_closed']}")
        if abs(dense_stats.final_cost - resolve.final_cost) \
                > DENSE_COST_RTOL * resolve.final_cost:
            fail(f"mesh of {size}: the dense re-solve's cost "
                 f"{dense_stats.final_cost} differs from the Woodbury "
                 f"re-solve's {resolve.final_cost}")
        if d_score or d_tr or not np.array_equal(best, best_pr):
            fail(f"mesh of {size}: the sharded CSM batch differs from one "
                 f"process's pair engine")
        if min(launches) == 0 or min(csm_launches) == 0:
            fail(f"mesh of {size}: a rank never launched the correlation "
                 f"kernel ({launches}, {csm_launches})")
        per_rank[size] = launches

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--config_file", str(ROOT / "config"
                                             / "default_config.lua"),
                       "--synthetic", "building", "--devices", "2", "--quiet"])
    print(f"  CLI --devices 2 on {torch.cuda.device_count()} card(s): rc {rc}, "
          f"{out.getvalue().strip()!r}", flush=True)
    if torch.cuda.device_count() == 1 and (
            rc != 1 or "device(s) visible" not in out.getvalue()):
        fail("--devices 2 on a one-card machine did not return 1 with the "
             "reference's message")
    return per_rank


def hitl_message_phase(cfg, closed, hitl_ref):
    """Phase 15's bridge: bench.py's HITL line pair, wire-encoded, through
    RosInputBridge.dispatch on phase 8's closed map, against phase 8's
    apply_hitl_line of the same line; then /write_output and
    /vectorize_output."""
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.viz import ros_encode
    from nautilus_tpu_torch.viz.bridge import RosInputBridge

    with tempfile.TemporaryDirectory() as tmp:
        poses, lines = Path(tmp) / "poses.txt", Path(tmp) / "map.csv"
        bcfg = cfg.replace(hitl_line_width=HITL_WIDTH,
                           pose_output_file=str(poses),
                           map_output_file=str(lines))
        solver = Solver(closed, bcfg)
        recorded, solve = [], solver.solve_slam

        def solve_and_record():
            recorded.append(solve())
            return recorded[-1]

        solver.solve_slam = solve_and_record
        bridge = RosInputBridge(solver, bcfg, verbose=False)
        buff = ros_encode.encode_hitl_input(*HITL_LINES)
        _, t_hitl = timed(lambda: bridge.dispatch(bridge.hitl_topic, buff))
        worst = 0.0
        for got, want in zip(recorded, hitl_ref):
            for g, w in zip(got.windows, want.windows):
                for a, b in ((g.initial_cost, w.initial_cost),
                             (g.final_cost, w.final_cost)):
                    worst = max(worst, abs(a - b) / abs(b))
        _, t_write = timed(lambda: bridge.dispatch(
            "/write_output", ros_encode.encode_write_msg()))
        _, t_vec = timed(lambda: bridge.dispatch(
            "/vectorize_output", ros_encode.encode_write_msg()))
        rows = len(poses.read_text().splitlines()) if poses.exists() else 0
        segments = len(lines.read_text().splitlines()) if lines.exists() \
            else 0
    c = closed.hitl_constraints[0] if closed.hitl_constraints else None
    print(f"  bridge: {len(buff)}-byte HitlSlamInputMsg on "
          f"{bridge.hitl_topic!r} in {t_hitl!r} s (phase 8's apply_hitl_line "
          f"{sum(st.total_wall_s for st in hitl_ref)!r} s of solves); poses "
          f"line A / B {len(c.line_a_poses) if c else 0} / "
          f"{len(c.line_b_poses) if c else 0}; per-window costs of "
          f"{len(recorded)} solves against phase 8's: largest relative "
          f"difference {worst!r} (rtol {BRIDGE_COST_RTOL})")
    print(f"  bridge: /write_output {t_write!r} s ({rows} pose lines), "
          f"/vectorize_output {t_vec!r} s ({segments} segments); handled "
          f"{bridge.handled}", flush=True)
    if len(recorded) != 2 or [len(st.windows) for st in recorded] != \
            [len(st.windows) for st in hitl_ref]:
        fail("the bridged HITL message did not run phase 8's two solves")
    if not worst <= BRIDGE_COST_RTOL:
        fail(f"the bridged HITL step's costs differ from phase 8's by "
             f"{worst} relative")
    if rows != closed.num_nodes or segments == 0 or bridge.handled != 3:
        fail("/write_output or /vectorize_output wrote no pose file or map")


def library_calls_phase(cfg, at_gate, gated_pairs, zero_counts, read_counts):
    """Phase 15's library calls on phase 6's gated pairs: best_scan_match
    per source (solution-implied rotation centres) and csm_match_grouped
    (centres 0), each against the pair engine on the same pairs.  Returns
    their correlation kernel launches."""
    import numpy as np
    from nautilus_tpu_torch.kernels.csm import (csm_match_grouped,
                                                csm_match_pairs, wrap_angle)
    from nautilus_tpu_torch.loop_closure import auto_lc

    params = auto_lc._csm_params_from_config(cfg)
    pts, msk = at_gate.problem.points, at_gate.problem.points_mask
    ss = np.array([s for s, _ in gated_pairs])
    tt = np.array([t for _, t in gated_pairs])
    centers = wrap_angle(at_gate.solution[ss, 2] - at_gate.solution[tt, 2])
    ref_c = csm_match_pairs(pts, msk, ss, tt, params,
                            rotation_centers=centers, engine="pair")
    ref_0 = csm_match_pairs(pts, msk, ss, tt, params, engine="pair")
    step_t, step_r = params.high_res, params.high_res / params.scan_range
    zero_counts()
    sources = sorted(set(ss.tolist()))
    best, t_best = timed(lambda: {s: auto_lc.best_scan_match(
        at_gate, s, tt[ss == s].tolist(), params) for s in sources})
    best_launches = read_counts()["correlate"]
    zero_counts()
    (g_scores, g_tr), t_grouped = timed(lambda: csm_match_grouped(
        pts, msk, ss, tt, params))
    grouped_launches = read_counts()["correlate"]
    d_best = [0.0, 0.0, 0.0]
    for s, (score, t, tr) in best.items():
        rows = np.nonzero(ss == s)[0]
        k = rows[int(np.argmax(ref_c[0][rows]))]
        if t != tt[k] and abs(ref_c[0][rows[tt[rows] == t][0]]
                              - ref_c[0][k]) > LIB_SCORE_ATOL:
            fail(f"best_scan_match picked scan {t} for {s}, the pair engine "
                 f"{tt[k]}")
        k = rows[tt[rows] == t][0]
        d_best = [max(d_best[0], abs(score - ref_c[0][k])),
                  max(d_best[1], float(np.abs(tr[:2] - ref_c[1][k, :2])
                                       .max())),
                  max(d_best[2], abs(float(tr[2]) - ref_c[1][k, 2]))]
    d_grp = [float(np.abs(g_scores - ref_0[0]).max()),
             float(np.abs(g_tr[:, :2] - ref_0[1][:, :2]).max()),
             float(np.abs(g_tr[:, 2] - ref_0[1][:, 2]).max())]
    print(f"  best_scan_match: {len(sources)} sources over "
          f"{len(gated_pairs)} gated pairs in {t_best!r} s, "
          f"{best_launches} correlation launches; against the pair engine "
          f"max |d score| {d_best[0]!r}, |d translation| {d_best[1]!r} m, "
          f"|d rotation| {d_best[2]!r} rad")
    print(f"  csm_match_grouped: {len(set(tt.tolist()))} targets in "
          f"{t_grouped!r} s, {grouped_launches} correlation launches; "
          f"against the pair engine max |d score| {d_grp[0]!r}, "
          f"|d translation| {d_grp[1]!r} m, |d rotation| {d_grp[2]!r} rad "
          f"(bars {LIB_SCORE_ATOL}, {step_t} m, {step_r!r} rad)", flush=True)
    for name, d, launches in (("best_scan_match", d_best, best_launches),
                              ("csm_match_grouped", d_grp,
                               grouped_launches)):
        if launches == 0:
            fail(f"{name} never launched the correlation kernel")
        if d[0] > LIB_SCORE_ATOL or d[1] > step_t + 1e-6 \
                or d[2] > step_r + 1e-6:
            fail(f"{name} disagrees with the pair engine on the same pairs")
    return best_launches + grouped_launches


def busy_share_phase(cfg, state, x0, walls6):
    """Phase 15's profile: phase 6's solve and auto-LC, each in its own
    torch.profiler session (utils/timer.profile_to, read in memory: the
    solve's trace would be hundreds of MB).  The device busy share is the
    union of the kernels' intervals over the region's wall under the
    profiler, and over phase 6's wall of the same work without it."""
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.timer import (device_busy_s, profile_to,
                                                span)

    solver = Solver(fresh_state(state, x0), cfg)
    shares = {}
    for name, fn in (("solve", solver.solve_slam),
                     ("auto-LC", lambda: auto_lc.solve_auto_lc(
                         solver, apply=True, verbose=False))):
        with profile_to() as prof:
            with span(f"nautilus {name}"):
                result, wall = timed(fn)
        t0 = time.perf_counter()
        busy = device_busy_s(prof)
        t_read = time.perf_counter() - t0
        events = len(prof.profiler.kineto_results.events())
        shares[name] = (busy / wall, busy / walls6[name]) if busy > 0 \
            else None
        print(f"  profiled {name}: wall {wall!r} s under the profiler "
              f"(phase 6: {walls6[name]!r} s without it), kernels busy "
              f"{busy!r} s; busy share {shares[name]!r} (profiled wall, "
              f"phase 6's wall); {events} events, read in {t_read!r} s",
              flush=True)
    counts = (len(result.candidates), len(result.gated_pairs),
              len(result.accepted))
    print(f"  profiled auto-LC candidates/gated/accepted {counts}")
    if None in shares.values():
        print("  busy share: the profile holds no kernel events, not "
              "measured")
    return shares


def visualizer_phase(cfg, state, x0, stats6, walls6, closed, hitl_ref,
                     at_gate, gated_pairs, zero_counts, read_counts):
    """Phase 15.  Returns (correlation launches of the library calls,
    busy shares)."""
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.viz.visualizer import SnapshotVisualizer

    vis = SnapshotVisualizer(record_clouds=False)
    solver = Solver(fresh_state(state, x0), cfg, visualizer=vis)
    stats, wall = timed(solver.solve_slam)
    windows = [s.window for s in vis.snapshots]
    rel = abs(stats.final_cost - stats6.final_cost) / abs(stats6.final_cost)
    print(f"  visualized solve_slam: wall {wall!r} s (phase 6 "
          f"{stats6.total_wall_s!r} s of windows), {len(vis.snapshots)} "
          f"snapshots (windows {windows}), {len(vis.correspondences)} "
          f"correspondence sets; final cost {stats.final_cost!r} against "
          f"phase 6's {stats6.final_cost!r} (relative {rel!r}, rtol "
          f"{VIZ_COST_RTOL})")
    if windows != [None] + [w.window for w in stats.windows]:
        fail("the visualized sweep did not draw the initial solution and "
             "every window")
    if not rel <= VIZ_COST_RTOL:
        fail("the visualized sweep's final cost differs from phase 6's")
    w = cfg.get_int("lidar_constraint_amount_max")
    vis = SnapshotVisualizer(record_clouds=False)
    solver = Solver(fresh_state(state, x0),
                    cfg.replace(lidar_constraint_amount_min=w),
                    visualizer=vis, per_iteration_viz=True)
    stats, wall = timed(solver.solve_slam)
    steps = len(vis.snapshots) - 2
    print(f"  per_iteration_viz, window {w} alone on the {solver.last_solver}"
          f" route: {stats.windows[0].iterations} LM steps, {steps} step "
          f"snapshots, wall {wall!r} s, final cost {stats.final_cost!r}",
          flush=True)
    if steps != stats.windows[0].iterations or solver.last_solver != "dense":
        fail("per_iteration_viz did not draw once per LM step on the dense "
             "route")
    hitl_message_phase(cfg, closed, hitl_ref)
    launches = library_calls_phase(cfg, at_gate, gated_pairs, zero_counts,
                                   read_counts)
    return launches, busy_share_phase(cfg, state, x0, walls6)


def trainer_phase(dev, state_at_gate, gated_pairs, threshold, shipped):
    """Phase 16: the embedding trainer on the card against the CPU, then
    the descriptor gate with the weights it wrote.  ``shipped``: phase 13's
    kept set and choice with the shipped weights."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.loop_closure import auto_lc, embedding

    feats, t_pairs = {}, {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        feats[name], t_pairs[name] = timed(
            lambda: embedding._training_pairs(seed=0, device=d))
    moved = sum(int(((a.cpu() - b).abs().amax(1) > 1e-5).sum())
                for a, b in zip(feats["cuda"], feats["cpu"]))
    d_feat = max(float((a.cpu() - b).abs().max())
                 for a, b in zip(feats["cuda"], feats["cpu"]))
    print(f"  training pairs: {len(feats['cpu'][0])}; built in "
          f"{t_pairs['cuda']!r} s on the card, {t_pairs['cpu']!r} s on the "
          f"CPU; features card vs CPU max |d| {d_feat!r}, rows beyond 1e-5: "
          f"{moved}", flush=True)
    losses, params, walls = {}, {}, {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        losses[name] = []
        params[name], walls[name] = timed(lambda: embedding.train(
            verbose=False, device=d, losses=losses[name]))
    lc, lp = np.asarray(losses["cuda"]), np.asarray(losses["cpu"])
    loss_rel = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    w_err = max(float((params["cuda"][k].cpu() - params["cpu"][k])
                      .abs().max()) for k in ("w1", "b1", "w2", "b2"))
    c_err = abs(float(params["cuda"]["calib"]) - float(params["cpu"]["calib"]))
    for name in ("cuda", "cpu"):
        steps_s = len(losses[name]) / (walls[name] - t_pairs[name])
        print(f"  train(300, seed=0) on {name}: wall {walls[name]!r} s "
              f"(training pairs about {t_pairs[name]!r} s of it), "
              f"{steps_s!r} steps/s without them; loss "
              f"{losses[name][0]!r} -> {losses[name][-1]!r}, calib "
              f"{float(params[name]['calib'])!r}")
    print(f"  card vs CPU: loss max relative {loss_rel!r} (rtol "
          f"{TRAIN_LOSS_RTOL}), weights max |d| {w_err!r} (atol "
          f"{TRAIN_WEIGHT_ATOL}), calib |d| {c_err!r} (atol "
          f"{TRAIN_CALIB_ATOL})", flush=True)
    if len(lc) != 300 or not np.all(np.isfinite(lc)):
        fail("the card's trainer did not take 300 finite steps")
    if not (loss_rel <= TRAIN_LOSS_RTOL and w_err <= TRAIN_WEIGHT_ATOL
            and c_err <= TRAIN_CALIB_ATOL):
        fail("the card's trainer departs from the CPU trainer")
    with tempfile.TemporaryDirectory() as tmp:
        path = embedding.save_params(params["cuda"], Path(tmp) / "w.npz")
        back = embedding.load_params(path, device=dev)
        if not all(torch.equal(back[k], params["cuda"][k]) for k in back):
            fail("the trained weights did not read back as written")
        st = dataclasses.replace(state_at_gate)
        kept, t_gate = timed(lambda: auto_lc.descriptor_gate(
            st, gated_pairs, threshold, None, weights_path=path))
    c = st._descriptor_gate_choice
    kept_s, choice_s = shipped
    print(f"  descriptor gate with the trained weights: self-check picked "
          f"{c['scorer']!r} (AUC embedding {c['auc_emb']!r}, hand "
          f"{c['auc_hand']!r}), kept {len(kept)} of {len(gated_pairs)} in "
          f"{t_gate!r} s; with the shipped weights {choice_s!r} kept "
          f"{len(kept_s)}; same set: {kept == kept_s}", flush=True)


def cpu_model():
    """The host CPU as lscpu names it: its "Model name", or where a virtual
    machine's says "unknown", its vendor, family and model numbers; and the
    CPUs this process may use."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60)
    f = {k.strip(): v.strip() for k, _, v in (
        line.partition(":") for line in out.stdout.splitlines())}
    name = f.get("Model name", "unknown")
    if name.lower() in ("unknown", "-", ""):
        name = (f"{f.get('Vendor ID', 'unknown vendor')} family "
                f"{f.get('CPU family', '?')} model {f.get('Model', '?')}")
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def referee_cost(prob, x, cfg, hitl=None, line_poses=None):
    """The referee's float64 cost of poses x at the final window's
    correspondences associated at x (bench.py's f64_cost), with HITL rows
    and their line poses where given."""
    import numpy as np
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    planar, edge = cpu.associate(prob, x,
                                 cfg.get_int("lidar_constraint_amount_max"),
                                 float(cfg.outlier_threshold))
    if hitl is not None:
        x = np.concatenate([x, line_poses])
    return cpu.total_cost(prob, x, planar, edge, float(cfg.translation_weight),
                          float(cfg.rotation_weight), hitl=hitl)


def hold_gap(what, gap, control=False):
    """A solution under test lies inside both referee bars; a control (a
    solution known to be short of the end) outside the tight one, or the
    bars could not tell the two apart."""
    if control and not gap >= REFEREE_COST_TIGHT:
        fail(f"{what} is only {gap} from the referee's final cost: the "
             f"{REFEREE_COST_TIGHT} bar cannot tell an unfinished solve")
    if not control and not gap < REFEREE_COST_TIGHT:   # < REFEREE_COST_REL
        fail(f"{what} is {gap} from the float64 referee's final cost, past "
             f"the {REFEREE_COST_TIGHT} bar (the JAX package's is "
             f"{REFEREE_COST_REL})")


def referee_solve(cfg, state, x0, gt, solves, say):
    """Phase 17's solve: the referee's growing-window sweep of the main
    path's input on the CPU from phase 6's x0, and every card sweep of the
    same input scored under its cost.  The sweep runs as two calls, through
    the next-to-last window and then the last, which is the same sweep; the
    solution between them and x0 are the controls.  solves: route -> (poses
    before auto-LC, card wall s)."""
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    from nautilus_tpu_torch.utils.metrics import ate

    t0 = time.perf_counter()
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    t_copy = time.perf_counter() - t0
    last = cfg.get_int("lidar_constraint_amount_max")
    t0 = time.perf_counter()
    x_early, head = cpu.solve_slam(
        prob, x0, cfg.replace(lidar_constraint_amount_max=last - 1))
    x_ref, tail = cpu.solve_slam(
        prob, x_early, cfg.replace(lidar_constraint_amount_min=last))
    wall = time.perf_counter() - t0
    say(f"referee solve_slam on the CPU: {len(prob.points)} poses, wall "
        f"{wall!r} s (copy from the card {t_copy!r} s); per window (window, "
        f"iterations, cost, wall s):")
    for w in head.windows + tail.windows:
        print(f"    {w['window']} {w['iterations']} {w['cost']!r} "
              f"{w['wall_s']!r}")
    t0 = time.perf_counter()
    c_ref = referee_cost(prob, x_ref, cfg)
    say(f"referee's float64 cost at its own solution {c_ref!r} (scored in "
        f"{time.perf_counter() - t0!r} s); ATE against ground truth: "
        f"referee {ate(x_ref, gt)['trans_rmse']!r} m, card band "
        f"{ate(solves['band'][0], gt)['trans_rmse']!r} m")
    for what, x in (("x0", x0),
                    (f"the referee's solution after window {last - 1}",
                     x_early)):
        c = referee_cost(prob, x, cfg)
        gap = abs(c - c_ref) / c_ref
        say(f"control, {what}: scores {c!r} under the referee's cost, gap "
            f"{gap!r} (must lie outside the {REFEREE_COST_TIGHT} bar; "
            f"outside the {REFEREE_COST_REL} bar: {gap >= REFEREE_COST_REL})")
        hold_gap(f"control {what}", gap, control=True)
    for route, (x, card_wall) in solves.items():
        c = referee_cost(prob, x, cfg)
        gap = abs(c - c_ref) / c_ref
        say(f"{route}: the card's solution scores {c!r} under the referee's "
            f"cost, gap {gap!r} (bars {REFEREE_COST_TIGHT} and "
            f"{REFEREE_COST_REL}); card solve_slam {card_wall!r} s, referee "
            f"{wall!r} s, ratio {wall / card_wall!r}")
        hold_gap(f"the card's {route} solve", gap)


def referee_hitl(small, say):
    """Phase 17's HITL step: phase 5's 32-pose slice at the solution phase
    5's step started from, through the port's step on the card and the
    referee's hitl_callback on the CPU.  Neither has the closures phase 5
    applied before it (the referee models none)."""
    import numpy as np
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    from nautilus_tpu_torch.cli import apply_hitl_line
    from nautilus_tpu_torch.solve.solver import Solver

    cfg, x_pre = small["cfg"], small["x_pre"]
    st = fresh_state(small["state"], x_pre)
    solver = Solver(st, cfg)
    _, card_wall = timed(lambda: apply_hitl_line(
        solver, HITL_SMALL_LINE.split(), verbose=False))
    v = [float(t) for t in HITL_SMALL_LINE.split()]
    line_a, line_b = (v[0:2], v[2:4]), (v[4:6], v[6:8])
    prob = cpu.CpuProblem.from_device_problem(st.problem)
    t0 = time.perf_counter()
    x_ref, stats = cpu.hitl_callback(prob, x_pre.copy(), cfg, line_a, line_b)
    wall = time.perf_counter() - t0
    rows = cpu.hitl_rows(prob, x_pre, cfg, line_a, line_b)
    c = st.hitl_constraints[0]
    card_nodes = sorted(k for k, _ in c.line_a_poses + c.line_b_poses)
    c_start = referee_cost(prob, x_pre, cfg, rows, np.zeros((1, 3)))
    c_ref = referee_cost(prob, x_ref, cfg, rows, stats.line_poses)
    c_card = referee_cost(prob, st.solution, cfg, rows, st.line_poses)
    gap_start = abs(c_start - c_ref) / c_ref
    gap = abs(c_card - c_ref) / c_ref
    say(f"HITL step on phase 5's slice ({st.num_nodes} poses, "
        f"{len(rows.node)} rows): poses selected card {card_nodes} referee "
        f"{sorted(rows.node.tolist())}; referee's float64 cost with the rows: "
        f"start {c_start!r} (gap {gap_start!r}, a control), referee "
        f"{c_ref!r}, card {c_card!r}, gap {gap!r} (bars {REFEREE_COST_TIGHT} "
        f"and {REFEREE_COST_REL}); line pose card "
        f"{st.line_poses.tolist()} referee {stats.line_poses.tolist()}; "
        f"card step {card_wall!r} s, referee {wall!r} s")
    if card_nodes != sorted(rows.node.tolist()) or not card_nodes:
        fail("the card's HITL step selected other poses than the referee's")
    if not np.all(np.isfinite(st.solution)) or not c_ref < c_start:
        fail("the HITL step did not lower the referee's cost")
    hold_gap("the HITL step's start", gap_start, control=True)
    hold_gap("the card's HITL step", gap)


def referee_csm(cfg, state, at_gate, gated_pairs, say):
    """Phase 17's scan matching: the CPU twin (baseline/cpu_csm.py) against
    the stage engine (fused coarse kernel) and the pair engine (correlation
    kernel) on the card, on bench.py's CPU-leg pairs at the reference params
    and on gated pairs of the main path at its params and centres.  Each
    engine runs with the product's bfloat16-rounded coarse table and with
    the float32 table the twin scores (``coarse_f32``): on a pair whose
    scores are flat (no overlap) the rounding can move the coarse argmax."""
    import numpy as np
    from nautilus_tpu_torch.baseline import cpu_csm
    from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match_pairs,
                                                wrap_angle)
    from nautilus_tpu_torch.loop_closure import auto_lc

    pts, msk = state.problem.points, state.problem.points_mask
    pts_h, msk_h = pts.cpu().numpy(), msk.cpu().numpy()
    n = state.num_nodes
    w = int(cfg.get("lc_match_window_size", 0))
    expanded = np.array([(s, t + d) for s, t in gated_pairs
                         for d in range(-w, w + 1)
                         if 0 <= t + d < n and t + d != s], np.int64)
    pick = np.unique(np.linspace(0, len(expanded) - 1,
                                 CSM_GATED_PAIRS).round().astype(np.int64))
    g_ss, g_tt = expanded[pick, 0], expanded[pick, 1]
    sets = (
        (f"bench.py's CPU-leg pairs (i, i+1), i < {CSM_BENCH_PAIRS}, at the "
         "reference params", np.arange(CSM_BENCH_PAIRS),
         np.arange(1, CSM_BENCH_PAIRS + 1), np.zeros(CSM_BENCH_PAIRS),
         CSMParams()),
        (f"{len(pick)} of the {len(expanded)} window-expanded gated pairs, "
         "evenly spaced, at the main path's params and centres", g_ss, g_tt,
         wrap_angle(at_gate.solution[g_ss, 2] - at_gate.solution[g_tt, 2]),
         auto_lc._csm_params_from_config(cfg)))
    for label, ss, tt, centers, params in sets:
        t0 = time.perf_counter()
        s_c, tr_c = cpu_csm.csm_match_batch_cpu(
            pts_h[ss], msk_h[ss], pts_h[tt], msk_h[tt], params,
            rotation_centers=centers)
        wall = time.perf_counter() - t0
        step_t, step_r = params.high_res, params.high_res / params.scan_range
        say(f"{label}: {list(zip(ss.tolist(), tt.tolist()))}; CPU twin "
            f"{len(ss) / wall!r} pairs/s ({wall!r} s)")
        # The product's bfloat16-rounded coarse table, then the float32 one
        # the twin scores.
        for engine, p in itertools.product(
                ("stage", "pair"), (params, params._replace(coarse_f32=True))):
            (s_e, tr_e), t_e = timed(lambda: csm_match_pairs(
                pts, msk, ss, tt, p, rotation_centers=centers, engine=engine))
            d_score = float(np.abs(s_e - s_c).max())
            d_tr = np.abs(tr_e - tr_c)
            d_trans, d_rot = float(d_tr[:, :2].max()), float(d_tr[:, 2].max())
            what = f"engine={engine} coarse_f32={p.coarse_f32}"
            say(f"  {what}: {len(ss) / t_e!r} pairs/s ({t_e!r} s); max |d "
                f"score| {d_score!r} (bar {CSM_SCORE_ATOL}), max |d "
                f"translation| {d_trans!r} m, max |d rotation| {d_rot!r} rad "
                f"(bar {CSM_TRANSFORM_ATOL}; grid {step_t} m, {step_r!r} rad)")
            if not np.all(np.isfinite(s_e)) or d_score > CSM_SCORE_ATOL \
                    or float(d_tr.max()) > CSM_TRANSFORM_ATOL:
                fail(f"{what} disagrees with the CPU twin on {label}")
            if d_trans > step_t + 1e-6 or d_rot > step_r + 1e-6:
                fail(f"{what} transforms differ from the CPU twin's by more "
                     f"than the finest grid step on {label}")


def referee_phase(cfg, state, x0, gt, solves, small, at_gate, gated_pairs,
                  card, read_counts):
    """Phase 17: the float64 CPU referee (nautilus_tpu_torch/baseline) on
    the card machine's CPU against the card.  Every line names the card and
    the host CPU.  Returns the kernels' launches in the phase."""
    import scipy  # the referee's own dependency: fail here without it

    host = cpu_model()

    def say(msg):
        print(f"  {msg} [{card}; host CPU {host}; scipy {scipy.__version__}]",
              flush=True)

    referee_solve(cfg, state, x0, gt, solves, say)
    referee_hitl(small, say)
    referee_csm(cfg, state, at_gate, gated_pairs, say)
    counts = read_counts()
    say(f"kernel launches in the referee phase: {counts}")
    for name, launches in counts.items():
        if launches == 0:
            fail(f"the referee phase never launched {name}")
    return counts


def main():
    if not (ROOT / "nautilus_tpu_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             "(nautilus_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")

    # -- 1. environment ------------------------------------------------------
    t_all = time.perf_counter()

    def banner(title):
        print(f"{title} [{time.perf_counter() - t_all!r} s into the run]",
              flush=True)

    banner("[1/18] environment")
    import nautilus_tpu_torch  # noqa: F401  (turns TF32 off)
    from nautilus_tpu_torch.kernels import _build, csm_coarse, csm_correlate
    card = card_line()
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"  card: {card}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is enabled after importing nautilus_tpu_torch")
    print("  tf32: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False")
    dev = torch.device("cuda")
    counters = (csm_coarse.fused_coarse, csm_correlate.correlate)

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counters}

    # -- 2. build ------------------------------------------------------------
    banner("[2/18] build: one nvcc per kernel source, started together")
    sources = [csm_coarse.SOURCE, csm_correlate.SOURCE]
    t0 = time.perf_counter()
    _build.build_all(sources)
    print(f"  built {len(sources)} kernels in {time.perf_counter() - t0!r} s")
    for src in sources:
        info = _build.build_info[src.name]
        print(f"  {src.name}: {info['path']} (nvcc {info['seconds']!r} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # -- 3. fused coarse kernel against plain ---------------------------------
    from nautilus_tpu_torch.kernels.csm import PAIR_BATCH, PAIR_CHUNK
    banner(f"[3/18] fused coarse kernel against plain (bench shapes at C=8 "
           f"and at the main path's chunk of C={PAIR_CHUNK} pairs, then the "
           f"gdc_2020 range)")
    cases = [kernel_case(dev, scan_range=30.0),
             kernel_case(dev, scan_range=30.0, C=PAIR_CHUNK, seed=2),
             kernel_case(dev, scan_range=8.5, seed=1)]
    main_shape = cases[1]

    # -- 4. correlation kernel against plain ----------------------------------
    banner(f"[4/18] correlation kernel against plain (the pair engine's batch "
           f"of B={PAIR_BATCH} pairs at 30 m, 12 m and 8.5 m; an integer "
           f"table in global memory)")
    corr_cases = [correlate_case(dev, 30.0, PAIR_BATCH, seed=4),
                  correlate_case(dev, 12.0, PAIR_BATCH, seed=5),
                  correlate_case(dev, 8.5, PAIR_BATCH, seed=6)]
    corr_err = max(max(c["max_abs_err"] for c in corr_cases),
                   correlate_global_case(dev))
    corr_shape = corr_cases[0]

    # -- 5. small-input reference -------------------------------------------
    banner("[5/18] small-input reference: card vs CPU")
    small = small_reference(
        "translation_weight=1\nrotation_weight=1\nlc_translation_weight=3\n"
        "lc_rotation_weight=3\nlidar_constraint_amount_min=1\n"
        "lidar_constraint_amount_max=3\noutlier_threshold=0.25\n"
        "max_lidar_range=10\ncsm_score_threshold=-3.5\n"
        "keyframe_local_uncertainty_filtering=true\nlc_match_window_size=2\n"
        "accuracy_change_stop_threshold=0.0001\n")

    # -- 6. main path ---------------------------------------------------------
    banner("[6/18] main path: make_problem(1000, building, 720 beams, seed 1) "
           "-> solve_slam -> solve_auto_lc(apply=True) -> write_poses")
    from nautilus_tpu_torch.core.luaconf import load_config
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.io.poses import read_pose_file, write_poses
    from nautilus_tpu_torch.loop_closure import auto_lc
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    cfg = load_config(ROOT / "config" / "default_config.lua")
    zero_counts()
    t0 = time.perf_counter()
    state, gt = make_problem(1000, "building", num_beams=720, seed=1,
                             odom_noise_trans=0.02, odom_noise_rot=0.008,
                             device=dev)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    x0 = state.solution.copy()
    solver = Solver(state, cfg)
    t0 = time.perf_counter()
    stats = solver.solve_slam()
    t_solve = time.perf_counter() - t0
    x_solved = state.solution.copy()
    report, t_lc, stages = traced(lambda: auto_lc.solve_auto_lc(
        solver, apply=True, verbose=False))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "poses.txt"
        write_poses(state, path)
        back = read_pose_file(path)
    main_counts = read_counts()
    launches = main_counts["fused_coarse"]

    sol = state.solution
    ate_odom = ate(x0, gt)["trans_rmse"]
    ate_solved = ate(x_solved, gt)["trans_rmse"]
    ate_closed = ate(sol, gt)["trans_rmse"]
    print(f"  preprocess (synthesize + normals + features) wall {t_pre!r} s")
    print(f"  solve_slam wall {t_solve!r} s; per window "
          "(window, iterations, initial cost, final cost, wall s):")
    print_windows(stats)
    print(f"  final cost {stats.final_cost!r} (BENCH_r05 f64 cost at the JAX "
          f"solution: {BENCH_R05['final_cost']})")
    print(f"  auto-LC wall {t_lc!r} s; stages {stages}")
    print(f"  candidates {len(report.candidates)} gated "
          f"{len(report.gated_pairs)} accepted {len(report.accepted)} "
          f"(BENCH_r05: {BENCH_R05['candidates']}/{BENCH_R05['gated']}/"
          f"{BENCH_R05['accepted']})")
    print(f"  ATE m: odometry {ate_odom!r} solved {ate_solved!r} closed "
          f"{ate_closed!r} (BENCH_r05: {BENCH_R05['ate_odometry']} / "
          f"{BENCH_R05['ate_solved']} / {BENCH_R05['ate_closed']})")
    print(f"  kernel launches in the main path: {main_counts}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30!r}"
          " GiB", flush=True)

    if sol.shape != (1000, 3) or not np.all(np.isfinite(sol)):
        fail("non-finite or mis-shaped poses after the main path")
    if len(back) != 1000 or not np.allclose(
            np.stack(list(back.values())), sol, atol=1e-6, rtol=0):
        fail("pose file read-back does not match the solution")
    if launches == 0:
        fail("the main path never launched the fused coarse kernel")
    if not report.applied:
        fail("auto-LC applied no closure")
    if not ate_closed < ate_odom:
        fail(f"closed ATE {ate_closed} is not below odometry ATE {ate_odom}")
    # Phase 10 times both band backends on this closed map's system.
    system_1000 = final_window_system(solver)

    # -- 7. pair engine ---------------------------------------------------------
    banner("[7/18] pair engine: bench.py's CSM leg, then the main path's "
           "gated pairs through engine='pair' against engine='stage'")
    zero_counts()
    bench_csm_leg(state, ("stage", "pair"))
    # The gated pairs as auto-LC matched them: at the solution it gated on.
    at_gate = dataclasses.replace(state, solution=x_solved)
    params = auto_lc._csm_params_from_config(cfg)
    match_w = int(cfg.get("lc_match_window_size", 0))
    threshold = float(cfg.csm_score_threshold)
    result = {}
    for engine in ("stage", "pair"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, transforms, best_tt, n_exp = auto_lc.match_gated_pairs(
            at_gate, report.gated_pairs, params, match_w, engine=engine)
        wall = time.perf_counter() - t0
        accepted = [(s, int(t)) for (s, _), t, sc in
                    zip(report.gated_pairs, best_tt, scores) if sc >= threshold]
        result[engine] = (scores, transforms, accepted, best_tt)
        print(f"  gated pairs engine={engine}: {n_exp} window-expanded pairs "
              f"in {wall!r} s ({n_exp / wall!r} pairs/s), accepted "
              f"{len(accepted)}", flush=True)
    pair_counts = read_counts()
    s_st, tr_st, acc_st, _ = result["stage"]
    s_pr, tr_pr, acc_pr, best_pr = result["pair"]
    d_trans = float(np.abs(tr_pr[:, :2] - tr_st[:, :2]).max())
    d_rot = float(np.abs(tr_pr[:, 2] - tr_st[:, 2]).max())
    d_score = float(np.abs(s_pr - s_st).max())
    step_t, step_r = params.high_res, params.high_res / params.scan_range
    print(f"  pair vs stage: accepted equal {acc_pr == acc_st} "
          f"(main path accepted {len(report.accepted)}); max |d score| "
          f"{d_score!r}; max |d translation| {d_trans!r} m (grid {step_t}); "
          f"max |d rotation| {d_rot!r} rad (grid {step_r!r})")
    print(f"  kernel launches in the pair-engine path: {pair_counts}",
          flush=True)
    if acc_st != report.accepted:
        fail("the stage engine's rerun accepted another set than auto-LC")
    if acc_pr != acc_st:
        fail("engine='pair' accepted another set than engine='stage'")
    if d_trans > step_t + 1e-6 or d_rot > step_r + 1e-6:
        fail("engine='pair' transforms differ from engine='stage' by more "
             "than the finest grid step")
    if pair_counts["correlate"] == 0:
        fail("the pair-engine path never launched the correlation kernel")

    # -- 8. HITL ----------------------------------------------------------------
    banner(f"[8/18] HITL: bench.py's scripted constraint (lines "
           f"{HITL_LINES}, hitl_line_width={HITL_WIDTH}) on the closed map")
    from nautilus_tpu_torch.cli import apply_hitl_line
    from nautilus_tpu_torch.solve.hitl import hitl_cost

    zero_counts()
    # Phase 15 sends the same message through the bridge on this closed map.
    closed = dataclasses.replace(
        fresh_state(state, sol), lc_factors=list(state.lc_factors))
    solver.config = cfg.replace(hitl_line_width=HITL_WIDTH)
    hitl_costs = []
    solve_slam = solver.solve_slam

    def solve_and_record():
        out = solve_slam()
        hitl_costs.append(hitl_cost(state))
        return out

    solver.solve_slam = solve_and_record
    tokens = [str(v) for pt in HITL_LINES for v in pt]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, second = apply_hitl_line(solver, tokens, verbose=False)
    torch.cuda.synchronize()
    t_hitl = time.perf_counter() - t0
    solver.solve_slam = solve_slam
    hitl_counts = read_counts()
    c = state.hitl_constraints[0]
    start = dataclasses.replace(state, solution=sol.copy(),
                                line_poses=np.zeros((1, 3)))
    cost_start = hitl_cost(start)
    print(f"  poses selected: line A {len(c.line_a_poses)} "
          f"{[k for k, _ in c.line_a_poses]}")
    print(f"  poses selected: line B {len(c.line_b_poses)} "
          f"{[k for k, _ in c.line_b_poses]}")
    for name, st in (("first solve (solved odometry + HITL)", first),
                     ("second solve (initial odometry + HITL)", second)):
        print(f"  {name}: wall {st.total_wall_s!r} s; per window (window, "
              "iterations, initial cost, final cost):")
        for w in st.windows:
            print(f"    {w.window} {w.iterations} {w.initial_cost!r} "
                  f"{w.final_cost!r}")
    print(f"  HITL residual cost: start {cost_start!r}, after the first "
          f"solve {hitl_costs[0]!r}, after the second {hitl_costs[1]!r}; "
          f"line pose {state.line_poses.tolist()}")
    print(f"  HITL step wall {t_hitl!r} s; kernel launches {hitl_counts}",
          flush=True)
    if not c.line_a_poses and not c.line_b_poses:
        fail("the HITL step selected no pose")
    if not (np.all(np.isfinite(state.solution))
            and np.all(np.isfinite(state.line_poses))):
        fail("non-finite poses after the HITL step")
    if not hitl_costs[0] < cost_start:
        fail(f"the HITL residual cost did not drop in the first solve "
             f"({cost_start} -> {hitl_costs[0]})")

    # -- 9. bag path ------------------------------------------------------------
    banner("[9/18] bag path: bench.py's GDC-scale bag (1000 poses, building, "
           "720 beams, seed 1, lz4 chunks) -> load_or_ingest -> the CLI with "
           "--write --vectorize and auto_lc=true")
    with tempfile.TemporaryDirectory() as tmp:
        bag_path_phase(Path(tmp), zero_counts, read_counts)

    # -- 10. CR backend -----------------------------------------------------------
    banner("[10/18] CR backend: make_problem(5000, building, 720 beams, "
           "seed 1) -> solve_slam, then scan against CR at N=1000 and N=5000")
    solver_5000 = cr_phase(cfg, dev, zero_counts, read_counts)
    scan_vs_cr("closed map of phase 6", solver, system_1000)
    scan_vs_cr("5000-pose solve", solver_5000,
               final_window_system(solver_5000))
    del solver_5000

    # -- 11. dense fallback -----------------------------------------------------
    banner(f"[11/18] dense fallback: phase 6's input with lr_factor_cap="
           f"{LR_CAP}: solve_slam -> solve_auto_lc(apply=True), the re-solve "
           "on dense Cholesky; then the gate's dense engine against its band "
           "engine")
    phase6 = {"report": report, "ate_closed": ate_closed,
              "ate_odom": ate_odom}
    phase11 = dense_fallback_phase(cfg, state, x0, gt, phase6, zero_counts,
                                   read_counts)

    # -- 12. the other routes ---------------------------------------------------
    banner("[12/18] other routes on the same input: dense sweep, CG on the "
           "closed graph, float64 from make_problem to the closed map")
    phase12 = other_routes_phase(cfg, state, x0, gt, stats, phase11, dev,
                                 zero_counts, read_counts)

    # -- 13. the small routes ---------------------------------------------------
    banner("[13/18] small routes at the main path's width: optimization type "
           "ALL, Hough normals, the descriptor gate on phase 6's gated pairs")
    zero_counts()
    all_route_phase(cfg, dev, state, x0)
    hough_phase(state)
    shipped_gate = descriptor_gate_phase(cfg, fresh_state(state, x_solved),
                                         list(report.gated_pairs),
                                         read_counts)

    # -- 14. the mesh ---------------------------------------------------------
    banner(f"[14/18] the mesh: phase 6's path over {MESH_SIZES} ranks on the "
           "one card, the sharded CSM batch against phase 7's pair engine, "
           "--devices 2 through the CLI")
    phase6["stats"] = stats
    mesh_launches = sharded_phase(cfg, dev, state, x0, gt, phase6, at_gate,
                                  (s_pr, tr_pr, best_pr), zero_counts)

    # -- 15. the visualizer, the bridge, the library calls ---------------------
    banner("[15/18] the visualizer and the ROS command bridge on phase 6's "
           "input, best_scan_match and csm_match_grouped on its gated pairs, "
           "the device busy share of its solve and auto-LC")
    zero_counts()
    library_launches, busy = visualizer_phase(
        cfg, state, x0, stats, {"solve": t_solve, "auto-LC": t_lc}, closed,
        (first, second), at_gate, list(report.gated_pairs), zero_counts,
        read_counts)

    # -- 16. the trainer ------------------------------------------------------
    banner("[16/18] the trainer: train(300 steps, seed 0) on the card against "
           "the CPU, then the descriptor gate with its weights")
    trainer_phase(dev, fresh_state(state, x_solved), list(report.gated_pairs),
                  float(cfg.get("lc_match_threshold", 0.5)), shipped_gate)

    # -- 17. the referee ------------------------------------------------------
    banner("[17/18] the float64 CPU referee: phase 6's input solved on the "
           "CPU against the band, dense and float64 sweeps; phase 5's HITL "
           "step; the CPU scan-match twin against both engines")
    solves = {"band": (x_solved, t_solve), **phase12["solves"]}
    zero_counts()
    referee_launches = referee_phase(cfg, state, x0, gt, solves, small,
                                     at_gate, list(report.gated_pairs), card,
                                     read_counts)

    # -- 18. the band scan's CUDA graphs -------------------------------------
    banner("[18/18] the band scan's CUDA graphs: solve_damped_banded and "
           "band_inverse_node_columns at N=1000 on phase 6's closed map, "
           "eager against graph replays")
    band_graph_phase(solver, system_1000)

    if "jax" in sys.modules or any(m == "nautilus_tpu" or
                                   m.startswith("nautilus_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported")
    print(f"total wall {time.perf_counter() - t_all!r} s", flush=True)

    def record(name, source, replaces, launches, err, shape, bound_kind,
               **more):
        return {**more, "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": shape["ms"],
                "plain_ms": shape["plain_ms"], "bound_ms": shape["bound_ms"],
                "bound_by": shape["bound_by"], "bound_kind": bound_kind,
                "share_of_bound": shape["share_of_bound"],
                "library_ms": shape["library_ms"]}

    print(json.dumps({"kernels": [
        record("fused_coarse",
               "nautilus_tpu_torch/kernels/csrc/csm_coarse.cu",
               "nautilus_tpu/kernels/csm_pallas.py:82", launches,
               max(c["max_abs_err"] for c in cases), main_shape,
               "float32 adds at 33.5e12/s (67 TFLOP/s counts an FMA as 2)",
               launches_dense_fallback=phase11["launches"]["fused_coarse"],
               launches_float64=phase12["fused_launches_f64"],
               launches_referee=referee_launches["fused_coarse"]),
        record("correlate",
               "nautilus_tpu_torch/kernels/csrc/csm_correlate.cu",
               "nautilus_tpu/kernels/csm_pallas.py:43",
               pair_counts["correlate"], corr_err, corr_shape,
               "HBM bytes at 3.35 TB/s",
               launches_sharded_per_rank=mesh_launches,
               launches_library_calls=library_launches,
               launches_referee=referee_launches["correlate"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
