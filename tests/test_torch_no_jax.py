"""The PyTorch port imports neither jax nor the JAX package."""

import ast
import os
import shutil
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
# The other routes: dense, CG and float64 solves, whole-cloud matching,
# Hough normals, and the descriptor gate with the package's own weights.
import torch
from nautilus_tpu_torch.core.preprocess import NormalParams, compute_normals
from nautilus_tpu_torch.loop_closure import embedding
from nautilus_tpu_torch.loop_closure.auto_lc import descriptor_gate
small = cfg.replace(lidar_constraint_amount_max=2)
for kind, dtype in (("dense", None), ("cg", None), ("auto", torch.float64)):
    st, _ = make_problem(6, "room", num_beams=120, seed=1, device="cpu",
                         dtype=dtype)
    s = Solver(st, small, linear_solver=kind)
    s.solve_slam()
    assert np.all(np.isfinite(st.solution)), kind
assert s.last_solver == "band" and s._current_x().dtype == torch.float64
s.solve_max_window(optimization_type="all")
hough = compute_normals(st.problem.points.float(), st.problem.points_mask,
                        NormalParams(method="hough"))
assert bool(torch.isfinite(hough).all())
assert "nautilus_tpu_torch" in embedding.default_weights_path().parts
kept = descriptor_gate(st, [(0, 1), (0, 5)], 0.5)
assert st._descriptor_gate_choice["scorer"] in ("emb", "hand")
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


BAG_PATH = """
import sys
sys.modules["jax"] = None                 # any jax import now fails
sys.path.insert(0, {root!r})
from pathlib import Path
import numpy as np
import torch
from nautilus_tpu_torch import cli
from nautilus_tpu_torch.ingest import native
from nautilus_tpu_torch.ingest.synthetic import write_synthetic_bag
from nautilus_tpu_torch.io.checkpoint import load_state, save_state
from nautilus_tpu_torch.solve import band
tmp = Path({tmp!r})
write_synthetic_bag(tmp / "run.bag", num_nodes=12, world_kind="room",
                    num_beams=180, seed=2, substeps=2)
(tmp / "run.lua").write_text(
    'dofile("default_config.lua")\\nbag_path="' + str(tmp / "run.bag") + '"\\n'
    'lidar_topic="/scan"\\nodom_topic="/odom"\\npose_number=12\\n'
    'lidar_constraint_amount_max=3\\n'
    'pose_output_file="' + str(tmp / "poses.txt") + '"\\n'
    'map_output_file="' + str(tmp / "map.csv") + '"\\n')
rc, solver, walls = cli.run(["--config_file", str(tmp / "run.lua"), "--write",
                             "--vectorize", "--device", "cpu", "--quiet"])
assert rc == 0 and (tmp / "map.csv").read_text().strip()
save_state(solver.state, tmp / "session.npz")
sol = solver.state.solution.copy()
solver.state.solution[:] = 0
load_state(solver.state, tmp / "session.npz")
assert np.array_equal(solver.state.solution, sol)
A = torch.eye(6).repeat(3, 1, 1) * 4
fac = band.cr_factor_tridiag(A, torch.zeros_like(A))
assert bool(fac.ok) and band.resolve_band_plan(2000, 3) == (8, "cr")
bad = [m for m in sys.modules
       if m == "nautilus_tpu" or m.startswith("nautilus_tpu.")]
assert not bad, bad
print("ok", native.reader_name(), sorted(walls))
"""


def test_bag_path_runs_with_jax_blocked(tmp_path):
    """The bag CLI path, a checkpoint round trip and the CR backend."""
    shutil.copy(ROOT / "config" / "default_config.lua", tmp_path)
    code = BAG_PATH.format(root=str(ROOT), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={**os.environ, "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("ok")


TRAINER_AND_VIZ = """
import sys
sys.modules["jax"] = None                 # any jax import now fails
sys.modules["nautilus_tpu"] = None        # and so does the JAX package's
sys.path.insert(0, {root!r})
from pathlib import Path
import numpy as np
import torch
from nautilus_tpu_torch.core.luaconf import load_config
from nautilus_tpu_torch.ingest.synthetic import make_problem
from nautilus_tpu_torch.kernels.csm import CSMParams, csm_match_grouped
from nautilus_tpu_torch.loop_closure import embedding, keyframes
from nautilus_tpu_torch.loop_closure.auto_lc import (best_scan_match,
                                                     solve_auto_lc)
from nautilus_tpu_torch.loop_closure.learned import passes_uncertainty_filter
from nautilus_tpu_torch.solve.solver import Solver
from nautilus_tpu_torch.utils import polynomial, timer
from nautilus_tpu_torch.viz import ros_encode
from nautilus_tpu_torch.viz.bridge import RosInputBridge
from nautilus_tpu_torch.viz.visualizer import (RosBridgeVisualizer,
                                               SnapshotVisualizer)
tmp = Path({tmp!r})
embedding.main(["--steps", "2", "--out", str(tmp / "w.npz"), "--device",
                "cpu"])
assert set(embedding.load_params(tmp / "w.npz")) == {{"w1", "b1", "w2", "b2",
                                                      "calib"}}
cfg = load_config({cfg!r}).replace(
    lidar_constraint_amount_max=2, pose_output_file=str(tmp / "poses.txt"),
    map_output_file=str(tmp / "map.csv"))
state, _ = make_problem(8, "room", num_beams=180, seed=0, device="cpu")
vis = SnapshotVisualizer(record_clouds=False)
solver = Solver(state, cfg, visualizer=vis, per_iteration_viz=True)
stats = solver.solve_slam()
assert len(vis.snapshots) == 1 + 2 + sum(w.iterations for w in stats.windows)
solve_auto_lc(solver, apply=False, verbose=False)
assert vis.lc_scans
bridge = RosInputBridge(solver, cfg, verbose=False)
bridge.dispatch("/hitl_slam_input", ros_encode.encode_hitl_input(
    (-5, -5), (5, -5), (-5, 5), (5, 5)))
bridge.dispatch("/write_output", ros_encode.encode_write_msg())
bridge.dispatch("/vectorize_output", ros_encode.encode_write_msg())
assert (tmp / "poses.txt").exists() and (tmp / "map.csv").exists()
assert not RosBridgeVisualizer().available
kf = keyframes.select_keyframes(state, cfg)
assert kf.any() and keyframes.keyframe_pairs(kf, 1) is not None
p = state.problem
assert isinstance(passes_uncertainty_filter(p.points[0], p.points_mask[0],
                                            p.normals[0], cfg), bool)
params = CSMParams(scan_range=6.0)
score, best, _ = best_scan_match(state, 0, [1, 2], params)
assert best in (1, 2) and np.isfinite(score)
scores, _ = csm_match_grouped(p.points, p.points_mask, [1, 2], [0, 0], params)
assert np.all(np.isfinite(scores))
assert polynomial.solve_quadratic(1.0, -3.0, 2.0) == [1.0, 2.0]
with timer.profile_to(tmp / "prof"):
    with timer.span("span"):
        torch.ones(4) + 1
assert (tmp / "prof" / timer.TRACE_FILE).exists()
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "nautilus_tpu"))]
assert not bad, bad
print("ok")
"""


def test_trainer_visualizer_and_bridge_run_with_jax_blocked(tmp_path):
    """This slice's modules: the trainer's main for a few steps, the
    visualizer, the bridge, keyframes, the library scan matches, the timers
    and the polynomial roots."""
    code = TRAINER_AND_VIZ.format(
        root=str(ROOT), tmp=str(tmp_path),
        cfg=str(ROOT / "config" / "default_config.lua"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_native_build_compiles_the_ports_own_source(tmp_path):
    from nautilus_tpu_torch.ingest import native
    assert native.SOURCE == PACKAGE / "native" / "bagreader.cc"
    assert native.SOURCE.is_file()
    cmd = native.build_command(tmp_path / "lib.so")
    if cmd is None:
        return          # no libbz2: the Python reader runs, nothing builds
    assert str(native.SOURCE) in cmd
    jax_tree = ROOT / "nautilus_tpu"
    assert not any(Path(a).is_relative_to(jax_tree) for a in cmd), cmd
    lib = native.library_path()
    assert lib.parent == ROOT / "build" / "nautilus_tpu_torch"


def test_no_jax_imports_in_package():
    offenders = [f"{path.relative_to(ROOT)}: {name}"
                 for path in sorted(PACKAGE.rglob("*.py"))
                 for name in _imported_names(path)
                 if name.split(".")[0] in ("jax", "jaxlib", "nautilus_tpu")]
    assert not offenders, offenders


REFEREE = """
import sys
sys.modules["jax"] = None                 # any jax import now fails
sys.modules["nautilus_tpu"] = None        # and so does the JAX package's
sys.path.insert(0, {root!r})
import numpy as np
from nautilus_tpu_torch.baseline import cpu_csm, cpu_reference as cpu
from nautilus_tpu_torch.core.luaconf import load_config
from nautilus_tpu_torch.ingest.synthetic import make_problem
cfg = load_config({cfg!r}).replace(lidar_constraint_amount_max=2)
state, _ = make_problem(6, "room", num_beams=180, seed=0, device="cpu")
prob = cpu.CpuProblem.from_device_problem(state.problem)
x, stats = cpu.solve_slam(prob, state.solution, cfg)
assert np.all(np.isfinite(x)) and np.isfinite(stats.final_cost)
pts = state.problem.points.numpy()
msk = state.problem.points_mask.numpy()
scores, _ = cpu_csm.csm_match_batch_cpu(pts[1:2], msk[1:2], pts[:1], msk[:1],
                                        cpu_csm.CSMParams(scan_range=6.0))
assert np.all(np.isfinite(scores))
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "nautilus_tpu"))]
assert not bad, bad
print("ok")
"""


def test_referee_runs_with_jax_blocked():
    """nautilus_tpu_torch.baseline imports neither jax nor the JAX package:
    a solve and a scan match of the referee with both blocked."""
    code = REFEREE.format(root=str(ROOT),
                          cfg=str(ROOT / "config" / "default_config.lua"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_product_modules_import_neither_the_referee_nor_scipy():
    """The referee lies beside the product: no module of the port outside
    baseline/ imports it, and none needs scipy."""
    referee = PACKAGE / "baseline"
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.is_relative_to(referee):
            continue
        for name in _imported_names(path):
            if name.split(".")[0] == "scipy" or name.startswith(
                    "nautilus_tpu_torch.baseline"):
                offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
    assert any("scipy" in name for path in referee.glob("*.py")
               for name in _imported_names(path))


def test_the_ports_extra_names_scipy_for_the_referee():
    import tomllib
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "scipy" in conf["project"]["optional-dependencies"][
        "nautilus_tpu_torch"]


def test_package_data_ships_what_the_port_loads(tmp_path):
    """An installed port can build its kernels and its bag reader and load
    its weights: every package-data glob names a package setuptools finds
    and matches files, and together they match every file the port reads
    from its own tree.  Outside a checkout, builds go to a per-user cache."""
    import tomllib

    from setuptools import find_packages

    from nautilus_tpu_torch.ingest import native
    from nautilus_tpu_torch.kernels import _build
    from nautilus_tpu_torch.loop_closure import embedding

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    tool = conf["tool"]["setuptools"]
    packages = set(find_packages(str(ROOT),
                                 include=tool["packages"]["find"]["include"]))
    shipped = set()
    for pkg, globs in tool["package-data"].items():
        if pkg.split(".")[0] != "nautilus_tpu_torch":
            continue
        assert pkg in packages, pkg
        for pattern in globs:
            hits = set((ROOT / pkg.replace(".", "/")).glob(pattern))
            assert hits, (pkg, pattern)
            shipped |= hits
    needed = {native.SOURCE, embedding.default_weights_path(),
              *_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")}
    assert needed <= shipped, needed - shipped
    assert conf["project"]["scripts"]["nautilus_tpu_torch"] == \
        "nautilus_tpu_torch.cli:main"
    assert conf["project"]["optional-dependencies"]["nautilus_tpu_torch"] \
        == ["torch", "scipy"]
    assert _build.BUILD_DIR == ROOT / "build" / "nautilus_tpu_torch"
    assert _build.build_dir(tmp_path) == \
        Path.home() / ".cache" / "nautilus_tpu_torch" / "build"


# Run as a script file: spawned workers import the main script as
# __mp_main__, so the blocks at its top hold in every rank of the mesh.
MESH = """
import sys
sys.modules["jax"] = None                 # any jax import now fails
sys.modules["nautilus_tpu"] = None        # and so does the JAX package's
sys.path.insert(0, {root!r})

if __name__ == "__main__":
    import numpy as np
    from nautilus_tpu_torch.core.luaconf import load_config
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.kernels.csm import CSMParams
    from nautilus_tpu_torch.parallel.sharded import (csm_match_pairs_sharded,
                                                     default_mesh)
    from nautilus_tpu_torch.solve.solver import Solver
    cfg = load_config({cfg!r}).replace(lidar_constraint_amount_max=3)
    state, _ = make_problem(8, "room", num_beams=180, seed=0, device="cpu")
    with default_mesh(2, "cpu") as mesh:
        stats = Solver(state, cfg, mesh=mesh).solve_slam()
        scores, _ = csm_match_pairs_sharded(
            state.problem.points, state.problem.points_mask, [1, 2, 3],
            [0, 1, 2], mesh, CSMParams(scan_range=6.0))
    assert mesh.closed and not any(p.is_alive() for p in mesh._procs)
    assert np.all(np.isfinite(scores)) and np.isfinite(stats.final_cost)
    print("ok", len(stats.windows))
"""


def test_mesh_workers_run_with_jax_blocked(tmp_path):
    """The workers of a mesh import neither jax nor the JAX package."""
    script = tmp_path / "mesh.py"
    script.write_text(MESH.format(
        root=str(ROOT), cfg=str(ROOT / "config" / "default_config.lua")))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("ok")
