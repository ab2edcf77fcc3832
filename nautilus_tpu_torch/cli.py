"""Command-line entry point of the PyTorch port (port of
nautilus_tpu/cli.py).

Flow: flags -> Lua config -> bag replay through the ingest cache (or a
synthetic world) -> preprocess on the device -> SLAMState -> optional
solution reload -> growing-window solve -> auto loop closure when the
config sets ``auto_lc=true`` -> HITL curation -> pose file and line map.

    python -m nautilus_tpu_torch.cli --config_file <cfg with bag_path> \
        --write --vectorize [--device cpu]
    python -m nautilus_tpu_torch.cli --config_file config/default_config.lua \
        --synthetic building --write

Curation commands:
- ``--hitl_replay FILE``: a text file of line pairs, one
  ``ax ay ax2 ay2 bx by bx2 by2`` per line (``#`` starts a comment),
  applied in order after the solve;
- ``--write`` / ``--vectorize``: write the pose file / the line map CSV
  once the solve and curation are done;
- ``--interactive``: a stdin loop of ``hitl <8 floats>``, ``write``,
  ``vectorize`` and ``quit``.

``--devices N`` (or the config key ``mesh_devices``) with N > 1 spreads the
solve and auto-LC's CSM batch over a mesh of N ranks on the run's device
(parallel/sharded.py); N may not exceed the visible cards (cores with
``--device cpu``).

``--ros`` publishes the solver's progress on the reference's rviz topics
(viz/visualizer.RosBridgeVisualizer) and, once the solve, auto-LC and the
one-shot commands are done, subscribes to ``hitl_lc_topic``,
/write_output and /vectorize_output (viz/bridge.RosInputBridge) and spins.
Where rospy does not import it returns 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def build_state(cfg, args, device, verbose=True, walls=None):
    """Ingest (the configured bag, or a synthetic world) and preprocess on
    ``device``; records the "ingest" and "preprocess" walls in ``walls``."""
    from nautilus_tpu_torch.core.preprocess import preprocess
    from nautilus_tpu_torch.core.problem import (SLAMState, build_problem,
                                                 resolve_solver_dtype)

    walls = {} if walls is None else walls
    dtype = resolve_solver_dtype(cfg.get("solver_dtype", "float32"))
    t0 = time.perf_counter()
    if args.synthetic:
        from nautilus_tpu_torch.ingest.synthetic import synthesize
        raw, _ = synthesize(num_nodes=cfg.get_int("pose_number"),
                            world_kind=args.synthetic,
                            seed=args.synthetic_seed)
        if verbose:
            print(f"Synthesized {raw.points.shape[0]} nodes "
                  f"({args.synthetic} world).")
    else:
        from nautilus_tpu_torch.ingest.cache import load_or_ingest
        bag = Path(cfg.bag_path)
        if not bag.is_absolute():
            bag = Path.cwd() / bag
        if verbose:
            print(f"Loading bag file [{bag}] ...")
        raw = load_or_ingest(bag, cfg, verbose=verbose)
        if verbose:
            print(f"Captured {raw.points.shape[0]} nodes.")
    walls["ingest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    normals, pi, pm, ei, em, _ = preprocess(raw.points, raw.points_mask,
                                            device, config=cfg)
    problem = build_problem(raw, normals, pi, pm, ei, em, device, dtype)
    state = SLAMState.from_problem(problem, raw.timestamps)
    walls["preprocess"] = time.perf_counter() - t0
    if verbose:
        print(f"Preprocessed (normals + features) in "
              f"{walls['preprocess']:.2f}s.")
    return state


def apply_hitl_line(solver, tokens, verbose=True):
    """One curation step from 8 numbers: line A's ends, then line B's."""
    from nautilus_tpu_torch.solve.hitl import HitlSlamInputMsg, hitl_callback
    vals = [float(t) for t in tokens]
    if len(vals) != 8:
        raise ValueError("hitl needs 8 floats: ax ay ax2 ay2 bx by bx2 by2")
    msg = HitlSlamInputMsg.from_points(vals[0:2], vals[2:4], vals[4:6],
                                       vals[6:8])
    return hitl_callback(solver, msg, verbose=verbose)


def _interactive(solver, cfg, verbose):
    from nautilus_tpu_torch.io.poses import write_poses
    from nautilus_tpu_torch.io.vectorize import vectorize
    if verbose:
        print("Waiting for Loop Closure input. Commands: "
              "hitl <8 floats> | write | vectorize | quit")
    for raw_line in sys.stdin:
        tokens = raw_line.split()
        if not tokens:
            continue
        cmd = tokens[0].lower()
        if cmd == "quit":
            break
        try:
            if cmd == "hitl":
                apply_hitl_line(solver, tokens[1:], verbose=verbose)
            elif cmd == "write":
                write_poses(solver.state, cfg.pose_output_file)
                print(f"Wrote poses to {cfg.pose_output_file}")
            elif cmd == "vectorize":
                vectorize(solver.state, cfg.map_output_file, verbose=verbose)
            else:
                print(f"Unknown command: {cmd}")
        except Exception as e:
            # Bad input or a failed solve must not end the curation session,
            # but after a CUDA error such as a device-side assert every
            # later call on the card fails.
            if _poisons_the_card(e):
                raise
            print(f"Error: {e}")


def _poisons_the_card(e: Exception) -> bool:
    text = str(e)
    return isinstance(e, RuntimeError) and ("CUDA error" in text
                                            or "device-side assert" in text)


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """The CLI's work: (exit code, Solver or None, walls in seconds by stage:
    ingest, preprocess, solve, auto_lc, hitl, write, vectorize)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="nautilus_tpu_torch")
    ap.add_argument("--config_file", required=True,
                    help="Lua config (same surface as the JAX package)")
    ap.add_argument("--solution_poses", default="",
                    help="pose file to load before solving")
    ap.add_argument("--synthetic", default="",
                    help="synthetic world (corner|room|office|building)")
    ap.add_argument("--synthetic_seed", type=int, default=0)
    ap.add_argument("--hitl_replay", default="",
                    help="file of HITL line pairs to apply after the solve")
    ap.add_argument("--write", action="store_true",
                    help="write pose_output_file after solving")
    ap.add_argument("--vectorize", action="store_true",
                    help="write map_output_file after solving")
    ap.add_argument("--interactive", action="store_true",
                    help="stdin command loop (hitl/write/vectorize/quit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card, so the CPU runs only with --device cpu)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the factor-parallel mesh (overrides the "
                         "config key mesh_devices)")
    ap.add_argument("--ros", action="store_true",
                    help="publish to rviz and subscribe to the reference's "
                         "command topics (hitl_lc_topic, /write_output, "
                         "/vectorize_output) via rospy, then spin")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    verbose = not args.quiet

    from nautilus_tpu_torch.core.luaconf import load_config, validate_config
    from nautilus_tpu_torch.core.problem import default_device

    cfg = load_config(args.config_file)
    validate_config(cfg, require_bag=not args.synthetic)
    walls = {}
    if not args.synthetic and not cfg.bag_path:
        print("Must specify an input bag!")
        return 1, None, walls
    visualizer = None
    if args.ros:
        from nautilus_tpu_torch.viz.visualizer import RosBridgeVisualizer
        visualizer = RosBridgeVisualizer()
        if not visualizer.available:
            print("--ros requested but rospy is not importable.")
            return 1, None, walls
    device = default_device(args.device)
    # --devices overrides mesh_devices; N > 1 spreads the solve and the CSM
    # batch over N ranks on the run's device.
    n_mesh = args.devices if args.devices is not None else int(
        cfg.get("mesh_devices", 0))
    mesh = None
    if n_mesh > 1:
        avail = _visible_devices(device)
        if n_mesh > avail:
            print(f"--devices/mesh_devices={n_mesh} but only {avail} "
                  f"device(s) visible.")
            return 1, None, walls
        from nautilus_tpu_torch.parallel.sharded import default_mesh
        mesh = default_mesh(n_mesh, device)
        if verbose:
            print(f"Sharding the solve over {n_mesh} devices "
                  f"({device.type}).")
    try:
        return _run(args, cfg, device, mesh, visualizer, walls, verbose)
    finally:
        if mesh is not None:
            mesh.close()


def _visible_devices(device) -> int:
    """Ranks a mesh may have on ``device``'s kind: the visible cards, or
    the cores on the CPU."""
    import torch
    return torch.cuda.device_count() if device.type == "cuda" \
        else (os.cpu_count() or 1)


def _run(args, cfg, device, mesh, visualizer, walls, verbose):
    from nautilus_tpu_torch.io.poses import load_solution, write_poses
    from nautilus_tpu_torch.io.vectorize import vectorize
    from nautilus_tpu_torch.solve.solver import Solver

    state = build_state(cfg, args, device, verbose=verbose, walls=walls)
    if args.solution_poses:
        if verbose:
            print("Loading solution poses.")
        load_solution(state, args.solution_poses, verbose=verbose)

    solver = Solver(state, cfg, visualizer=visualizer,
                    linear_solver=cfg.get("linear_solver", "auto"),
                    assembly=cfg.get("assembly", None) or None, mesh=mesh)
    t0 = time.perf_counter()
    stats = solver.solve_slam()
    walls["solve"] = time.perf_counter() - t0
    if verbose:
        print(f"Solved {state.num_nodes} poses in {walls['solve']:.2f}s; "
              f"final cost {stats.final_cost:.4f}.")

    if cfg.get("auto_lc", False):
        from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
        t0 = time.perf_counter()
        solve_auto_lc(solver, apply=True, verbose=verbose)
        walls["auto_lc"] = time.perf_counter() - t0

    if args.hitl_replay:
        t0 = time.perf_counter()
        for line in Path(args.hitl_replay).read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                apply_hitl_line(solver, line.split(), verbose=verbose)
        walls["hitl"] = time.perf_counter() - t0

    if args.write:
        t0 = time.perf_counter()
        write_poses(state, cfg.pose_output_file)
        walls["write"] = time.perf_counter() - t0
        if verbose:
            print(f"Wrote poses to {cfg.pose_output_file}")
    if args.vectorize:
        t0 = time.perf_counter()
        vectorize(state, cfg.map_output_file, verbose=verbose)
        walls["vectorize"] = time.perf_counter() - t0
    if args.ros:
        from nautilus_tpu_torch.viz.bridge import RosInputBridge
        bridge = RosInputBridge(solver, cfg, verbose=verbose)
        bridge.start()
        bridge.spin()
        return 0, solver, walls
    if args.interactive:
        _interactive(solver, cfg, verbose)
    return 0, solver, walls


if __name__ == "__main__":
    sys.exit(main())
