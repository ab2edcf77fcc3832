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
   line, per-window costs and the HITL residual cost.

Each path (6, 7, 8) starts with every launch count at 0 and reads them when
it ends.  Exits non-zero on any failure.  The last line is one JSON object
{"ok": true, "device": {...}}; the line before it holds the card's name and
power limit, and the one before that the kernels' JSON record (launches on
their path; times, bound and library call at the main path's shapes; the
largest error over every case).
"""

import dataclasses
import json
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
    """The slice at small size on the card and on the CPU."""
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
    print("[1/8] environment", flush=True)
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
    print("[2/8] build: one nvcc per kernel source, started together",
          flush=True)
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
    print(f"[3/8] fused coarse kernel against plain (bench shapes at C=8 and "
          f"at the main path's chunk of C={PAIR_CHUNK} pairs, then the "
          f"gdc_2020 range)", flush=True)
    cases = [kernel_case(dev, scan_range=30.0),
             kernel_case(dev, scan_range=30.0, C=PAIR_CHUNK, seed=2),
             kernel_case(dev, scan_range=8.5, seed=1)]
    main_shape = cases[1]

    # -- 4. correlation kernel against plain ----------------------------------
    print(f"[4/8] correlation kernel against plain (the pair engine's batch "
          f"of B={PAIR_BATCH} pairs at 30 m, 12 m and 8.5 m; an integer "
          f"table in global memory)", flush=True)
    corr_cases = [correlate_case(dev, 30.0, PAIR_BATCH, seed=4),
                  correlate_case(dev, 12.0, PAIR_BATCH, seed=5),
                  correlate_case(dev, 8.5, PAIR_BATCH, seed=6)]
    corr_err = max(max(c["max_abs_err"] for c in corr_cases),
                   correlate_global_case(dev))
    corr_shape = corr_cases[0]

    # -- 5. small-input reference -------------------------------------------
    print("[5/8] small-input reference: card vs CPU", flush=True)
    small_reference(
        "translation_weight=1\nrotation_weight=1\nlc_translation_weight=3\n"
        "lc_rotation_weight=3\nlidar_constraint_amount_min=1\n"
        "lidar_constraint_amount_max=3\noutlier_threshold=0.25\n"
        "max_lidar_range=10\ncsm_score_threshold=-3.5\n"
        "keyframe_local_uncertainty_filtering=true\nlc_match_window_size=2\n"
        "accuracy_change_stop_threshold=0.0001\n")

    # -- 6. main path ---------------------------------------------------------
    print("[6/8] main path: make_problem(1000, building, 720 beams, seed 1) "
          "-> solve_slam -> solve_auto_lc(apply=True) -> write_poses",
          flush=True)
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
    t0 = time.perf_counter()
    report = auto_lc.solve_auto_lc(solver, apply=True, verbose=False)
    t_lc = time.perf_counter() - t0
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
    for w in stats.windows:
        print(f"    {w.window} {w.iterations} {w.initial_cost!r} "
              f"{w.final_cost!r} {w.wall_s!r}")
    print(f"  final cost {stats.final_cost!r} (BENCH_r05 f64 cost at the JAX "
          f"solution: {BENCH_R05['final_cost']})")
    print(f"  auto-LC wall {t_lc!r} s; stages {report.stage_walls}")
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

    # -- 7. pair engine ---------------------------------------------------------
    print("[7/8] pair engine: bench.py's CSM leg, then the main path's gated "
          "pairs through engine='pair' against engine='stage'", flush=True)
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
        result[engine] = (scores, transforms, accepted)
        print(f"  gated pairs engine={engine}: {n_exp} window-expanded pairs "
              f"in {wall!r} s ({n_exp / wall!r} pairs/s), accepted "
              f"{len(accepted)}", flush=True)
    pair_counts = read_counts()
    s_st, tr_st, acc_st = result["stage"]
    s_pr, tr_pr, acc_pr = result["pair"]
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
    print(f"[8/8] HITL: bench.py's scripted constraint (lines "
          f"{HITL_LINES}, hitl_line_width={HITL_WIDTH}) on the closed map",
          flush=True)
    from nautilus_tpu_torch.cli import apply_hitl_line
    from nautilus_tpu_torch.solve.hitl import hitl_cost

    zero_counts()
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

    if "jax" in sys.modules or any(m == "nautilus_tpu" or
                                   m.startswith("nautilus_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported")
    print(f"total wall {time.perf_counter() - t_all!r} s", flush=True)

    def record(name, source, replaces, launches, err, shape, bound_kind):
        return {"name": name, "route": "cuda", "source": source,
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
               "float32 adds at 33.5e12/s (67 TFLOP/s counts an FMA as 2)"),
        record("correlate",
               "nautilus_tpu_torch/kernels/csrc/csm_correlate.cu",
               "nautilus_tpu/kernels/csm_pallas.py:43",
               pair_counts["correlate"], corr_err, corr_shape,
               "HBM bytes at 3.35 TB/s")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
