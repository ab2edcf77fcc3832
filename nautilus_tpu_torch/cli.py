"""Command-line entry point of the PyTorch port (port of
nautilus_tpu/cli.py, the synthetic-world path).

Flow: flags -> Lua config -> synthetic world -> preprocess on the device ->
SLAMState -> optional solution reload -> growing-window solve -> auto loop
closure when the config sets ``auto_lc=true`` -> HITL curation -> pose file.

    python -m nautilus_tpu_torch.cli --config_file config/default_config.lua \
        --synthetic building --write [--device cuda]

Curation commands:
- ``--hitl_replay FILE``: a text file of line pairs, one
  ``ax ay ax2 ay2 bx by bx2 by2`` per line (``#`` starts a comment),
  applied in order after the solve;
- ``--interactive``: a stdin loop of ``hitl <8 floats>``, ``write`` and
  ``quit``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

# Flags of the JAX CLI that the port does not have yet (ROADMAP.md).
_NOT_PORTED = {"--vectorize": "vectorize and checkpoint", "--ros": "viz",
               "--devices": "sharded"}


def build_state(cfg, args, device, verbose=True):
    from nautilus_tpu_torch.core.preprocess import preprocess
    from nautilus_tpu_torch.core.problem import (SLAMState, build_problem,
                                                 resolve_solver_dtype)
    from nautilus_tpu_torch.ingest.synthetic import synthesize

    dtype = resolve_solver_dtype(cfg.get("solver_dtype", "float32"))
    raw, _ = synthesize(num_nodes=cfg.get_int("pose_number"),
                        world_kind=args.synthetic, seed=args.synthetic_seed)
    if verbose:
        print(f"Synthesized {raw.points.shape[0]} nodes "
              f"({args.synthetic} world).")
    t0 = time.perf_counter()
    normals, pi, pm, ei, em, _ = preprocess(raw.points, raw.points_mask,
                                            device, config=cfg)
    problem = build_problem(raw, normals, pi, pm, ei, em, device, dtype)
    if verbose:
        print(f"Preprocessed (normals + features) in "
              f"{time.perf_counter() - t0:.2f}s.")
    return SLAMState.from_problem(problem, raw.timestamps)


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
    if verbose:
        print("Waiting for Loop Closure input. Commands: "
              "hitl <8 floats> | write | quit")
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
                raise NotImplementedError(
                    "vectorize is not yet ported (ROADMAP.md section 1, "
                    "'vectorize and checkpoint')")
            else:
                print(f"Unknown command: {cmd}")
        except (ValueError, NotImplementedError, OSError) as e:
            # Bad input must not end the curation session.
            print(f"Error: {e}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    for flag, item in _NOT_PORTED.items():
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise NotImplementedError(
                f"{flag} is not yet ported (ROADMAP.md section 1, '{item}')")
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
    ap.add_argument("--interactive", action="store_true",
                    help="stdin command loop (hitl/write/quit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card, so the CPU runs only with --device cpu)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    verbose = not args.quiet

    from nautilus_tpu_torch.core.luaconf import load_config, validate_config
    from nautilus_tpu_torch.core.problem import default_device
    from nautilus_tpu_torch.io.poses import load_solution, write_poses
    from nautilus_tpu_torch.solve.solver import Solver

    cfg = load_config(args.config_file)
    validate_config(cfg, require_bag=not args.synthetic)
    if not args.synthetic:
        raise NotImplementedError(
            "bag ingest is not yet ported (ROADMAP.md section 1, 'bag "
            "ingest'); pass --synthetic")
    device = default_device(args.device)

    state = build_state(cfg, args, device, verbose=verbose)
    if args.solution_poses:
        if verbose:
            print("Loading solution poses.")
        load_solution(state, args.solution_poses, verbose=verbose)

    solver = Solver(state, cfg,
                    linear_solver=cfg.get("linear_solver", "auto"))
    t0 = time.perf_counter()
    stats = solver.solve_slam()
    if verbose:
        print(f"Solved {state.num_nodes} poses in "
              f"{time.perf_counter() - t0:.2f}s; final cost "
              f"{stats.final_cost:.4f}.")

    if cfg.get("auto_lc", False):
        from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
        solve_auto_lc(solver, apply=True, verbose=verbose)

    if args.hitl_replay:
        for line in Path(args.hitl_replay).read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                apply_hitl_line(solver, line.split(), verbose=verbose)

    if args.write:
        write_poses(state, cfg.pose_output_file)
        if verbose:
            print(f"Wrote poses to {cfg.pose_output_file}")
    if args.interactive:
        _interactive(solver, cfg, verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
