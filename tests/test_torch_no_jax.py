"""The PyTorch port imports neither jax nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "nautilus_tpu_torch"

SLICE = """
import sys
sys.modules["jax"] = None                 # any jax import now fails
sys.path.insert(0, {root!r})
import nautilus_tpu_torch
from nautilus_tpu_torch.core.luaconf import load_config
from nautilus_tpu_torch.ingest.synthetic import make_problem
from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
from nautilus_tpu_torch.solve.solver import Solver
import numpy as np
cfg = load_config({cfg!r})
state, gt = make_problem(8, "room", num_beams=180, seed=0, device="cpu")
solver = Solver(state, cfg)
stats = solver.solve_slam()
report = solve_auto_lc(solver, apply=True, verbose=False)
from nautilus_tpu_torch.kernels.csm import CSMParams, csm_match_pairs
scores, _ = csm_match_pairs(state.problem.points, state.problem.points_mask,
                            [1, 2], [0, 1], CSMParams(scan_range=6.0),
                            engine="pair")
assert np.all(np.isfinite(scores))
from nautilus_tpu_torch.cli import apply_hitl_line
apply_hitl_line(solver.__class__(state, cfg.replace(hitl_line_width=0.3)),
                "-5 -5 5 -5 -5 5 5 5".split(), verbose=False)
assert len(state.hitl_constraints) == 1 and state.line_poses.shape == (1, 3)
assert np.all(np.isfinite(state.solution)) and state.solution.shape == (8, 3)
bad = [m for m in sys.modules
       if m == "nautilus_tpu" or m.startswith("nautilus_tpu.")]
assert not bad, bad
print("ok", len(stats.windows))
"""


def test_slice_runs_with_jax_blocked():
    code = SLICE.format(root=str(ROOT),
                        cfg=str(ROOT / "config" / "default_config.lua"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("ok")


def test_no_jax_imports_in_package():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "nautilus_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
