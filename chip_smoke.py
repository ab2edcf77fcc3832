#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nautilus_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the TF32 flags the package turns off;
2. build: compiles the CSM coarse kernel from kernels/csrc/csm_coarse.cu;
3. kernel against plain: the kernel and its plain PyTorch version on the
   same inputs at the benchmark shapes (C=8, and the main path's chunk of
   PAIR_CHUNK pairs) and at the gdc_2020 scan range, with max abs error,
   argmax agreement and CUDA-event times;
4. small-input reference: the port's slice on the card against the same
   slice on the CPU (the CPU path is held to the JAX package by the tests);
5. main path: the GDC-scale synthetic (1000 poses, building world, 720
   beams, seed 1) through solve_slam -> solve_auto_lc(apply=True) ->
   write_poses, counting kernel launches.

Exits non-zero on any failure.  The last line is one JSON object
{"ok": true, "device": {...}}; the line before it holds the card's name and
power limit, and the one before that the kernels' JSON record (times at the
main path's shapes, the largest error over every case).
"""

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
BENCH_R05 = {"candidates": 22, "gated": 49, "accepted": 27,
             "final_cost": 92.4868, "ate_odometry": 0.3303,
             "ate_solved": 0.5621, "ate_closed": 0.1182}


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


def kernel_case(dev, scan_range, C=8, P=768, seed=0):
    """Kernel vs plain on coarse-stage inputs built the way the matcher
    builds them, with ~10% masked points and points on cell edges."""
    import numpy as np
    import torch
    from nautilus_tpu_torch.kernels import csm, csm_coarse

    params = csm.CSMParams(scan_range=scan_range)
    res = params.low_res
    cells = params.kernel_cells(res)
    noff = 2 * params.offset_cells(res) + 1
    n_rot = int(np.ceil(2 * params.rotation_restriction / (res / scan_range)))
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, scan_range, (C, P))
    a = rng.uniform(-np.pi, np.pi, (C, P))
    pts = np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)
    # Points exactly on cell edges at theta = 0 (first rotation below).
    edges = (np.arange(64) * res - scan_range + 3 * res).astype(np.float32)
    pts[:, :64, 0] = edges
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
    T = tables.shape[1]

    out_k = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    out_p = csm_coarse.fused_coarse_reference(parked, thetas, tables, **kw)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    close = bool(torch.allclose(out_k, out_p, rtol=RTOL, atol=ATOL))
    fk, fp = out_k.reshape(C, -1), out_p.reshape(C, -1)
    ak, ap = fk.argmax(1), fp.argmax(1)
    rows = torch.arange(C, device=dev)
    ties = (fp[rows, ak] == fp[rows, ap]) | (fk[rows, ak] == fk[rows, ap])
    argmax_ok = bool(((ak == ap) | ties).all())
    n_same = int((ak == ap).sum())
    ms = cuda_ms(lambda: csm_coarse.fused_coarse(parked, thetas, tables, **kw),
                 20)
    plain_ms = cuda_ms(lambda: csm_coarse.fused_coarse_reference(
        parked, thetas, tables, **kw), 5)
    smem = csm_coarse.table_in_shared_memory(T, P)
    print(f"  scan_range={scan_range} C={C} P={P} R={n_rot} cells={cells} "
          f"noff={noff} T={T} table_in_smem={smem}: max_abs_err={err!r} "
          f"allclose(rtol={RTOL},atol={ATOL})={close} "
          f"argmax_equal={n_same}/{C} kernel_ms={ms!r} plain_ms={plain_ms!r}",
          flush=True)
    if not close:
        fail(f"kernel disagrees with plain version (max abs err {err})")
    if not argmax_ok:
        fail("kernel argmax differs from the plain version's beyond a tie")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def small_reference(cfg_text):
    """The slice at small size on the card and on the CPU."""
    import numpy as np
    from nautilus_tpu_torch.core.luaconf import load_config_text
    from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
    from nautilus_tpu_torch.kernels.csm import CSMParams
    from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
    from nautilus_tpu_torch.solve.solver import Solver

    cfg = load_config_text(cfg_text)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _ = reverse_traversal_problem(3, device=dev)
        solver = Solver(state, cfg)
        solver.solve_slam()
        rep = solve_auto_lc(solver, apply=True, verbose=False,
                            csm_params=CSMParams(scan_range=10.0,
                                                 high_res=0.05))
        out[dev] = (state.solution.copy(), rep.accepted)
    sol_c, acc_c = out["cpu"]
    sol_g, acc_g = out["cuda"]
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
    print("[1/5] environment", flush=True)
    import nautilus_tpu_torch  # noqa: F401  (turns TF32 off)
    from nautilus_tpu_torch.kernels import csm_coarse
    card = card_line()
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"  card: {card}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is enabled after importing nautilus_tpu_torch")
    print("  tf32: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False")
    dev = torch.device("cuda")

    # -- 2. build ------------------------------------------------------------
    print("[2/5] build", flush=True)
    t0 = time.perf_counter()
    csm_coarse.build()
    print(f"  built {csm_coarse.build_info['path']} in "
          f"{time.perf_counter() - t0!r} s (nvcc {csm_coarse.build_info['seconds']!r} s)")
    for line in csm_coarse.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernel against plain --------------------------------------------
    from nautilus_tpu_torch.kernels.csm import PAIR_CHUNK
    print(f"[3/5] kernel against plain (bench shapes at C=8 and at the main "
          f"path's chunk of C={PAIR_CHUNK} pairs, then the gdc_2020 range)",
          flush=True)
    cases = [kernel_case(dev, scan_range=30.0),
             kernel_case(dev, scan_range=30.0, C=PAIR_CHUNK, seed=2),
             kernel_case(dev, scan_range=8.5, seed=1)]
    main_shape = cases[1]

    # -- 4. small-input reference -------------------------------------------
    print("[4/5] small-input reference: card vs CPU", flush=True)
    small_reference(
        "translation_weight=1\nrotation_weight=1\nlc_translation_weight=3\n"
        "lc_rotation_weight=3\nlidar_constraint_amount_min=1\n"
        "lidar_constraint_amount_max=3\noutlier_threshold=0.25\n"
        "max_lidar_range=10\ncsm_score_threshold=-3.5\n"
        "keyframe_local_uncertainty_filtering=true\nlc_match_window_size=2\n"
        "accuracy_change_stop_threshold=0.0001\n")

    # -- 5. main path ---------------------------------------------------------
    print("[5/5] main path: make_problem(1000, building, 720 beams, seed 1) "
          "-> solve_slam -> solve_auto_lc(apply=True) -> write_poses",
          flush=True)
    from nautilus_tpu_torch.core.luaconf import load_config
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.io.poses import read_pose_file, write_poses
    from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
    from nautilus_tpu_torch.solve.solver import Solver
    from nautilus_tpu_torch.utils.metrics import ate

    cfg = load_config(ROOT / "config" / "default_config.lua")
    csm_coarse.fused_coarse.launches = 0
    torch.cuda.synchronize()
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
    report = solve_auto_lc(solver, apply=True, verbose=False)
    t_lc = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "poses.txt"
        write_poses(state, path)
        back = read_pose_file(path)
    torch.cuda.synchronize()
    launches = csm_coarse.fused_coarse.launches

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
    print(f"  fused_coarse launches in the main path: {launches}")
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
    if "jax" in sys.modules or any(m == "nautilus_tpu" or
                                   m.startswith("nautilus_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported")
    print(f"total wall {time.perf_counter() - t_all!r} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_coarse", "route": "cuda",
        "source": "nautilus_tpu_torch/kernels/csrc/csm_coarse.cu",
        "replaces": "nautilus_tpu/kernels/csm_pallas.py:82",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
