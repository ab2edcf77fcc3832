"""PyTorch port: the CLI slice (synthetic world -> solve -> auto-LC ->
pose file) against the JAX CLI."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from nautilus_tpu import cli as jax_cli
from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.io.poses import read_pose_file

CFG = """
dofile("default_config.lua")
pose_number=25
lidar_constraint_amount_max=4
auto_lc=true
pose_output_file="{poses}"
"""


def _run(main, tmp_path, name, extra=()):
    cfg = tmp_path / f"{name}.lua"
    poses = tmp_path / f"{name}_poses.txt"
    shutil.copy(Path(__file__).resolve().parents[1] / "config"
                / "default_config.lua", tmp_path / "default_config.lua")
    cfg.write_text(CFG.format(poses=poses))
    rc = main(["--config_file", str(cfg), "--synthetic", "building",
               "--synthetic_seed", "3", "--write", "--quiet", *extra])
    assert rc == 0
    return read_pose_file(poses)


def test_cli_pose_file_matches_jax(tmp_path):
    jp = _run(jax_cli.main, tmp_path, "jax")
    tp = _run(torch_cli.main, tmp_path, "torch", ("--device", "cpu"))
    assert list(tp) == list(jp) and len(tp) == 25
    # This corridor map leaves poses weakly constrained along the corridor:
    # the float32 cost is flat to its rounding noise over ~4e-4 m there, so
    # which LM steps are accepted is noise.  The JAX package's own fused
    # and per-window sweeps differ by 4.3e-4 on this input.
    np.testing.assert_allclose(np.stack(list(tp.values())),
                               np.stack(list(jp.values())), atol=1e-3, rtol=0)


def _cfg(tmp_path, name, extra):
    cfg = tmp_path / f"{name}.lua"
    shutil.copy(Path(__file__).resolve().parents[1] / "config"
                / "default_config.lua", tmp_path / "default_config.lua")
    cfg.write_text(CFG.format(poses=tmp_path / f"{name}_poses.txt")
                   .replace("pose_number=25", "pose_number=10")
                   .replace("auto_lc=true", "auto_lc=false") + extra)
    return ["--config_file", str(cfg), "--synthetic", "room", "--quiet",
            "--device", "cpu"]


# The reference's answers: without rospy, and to more ranks than there are
# devices (cores with --device cpu).
@pytest.mark.parametrize("flag,message", [
    ("--ros", "--ros requested but rospy is not importable."),
    ("--devices=4096", "--devices/mesh_devices=4096 but only"),
])
def test_refused_flags_return_1(tmp_path, capsys, flag, message):
    rc, solver, _ = torch_cli.run(_cfg(tmp_path, "refused", "") + [flag])
    assert rc == 1 and solver is None
    assert message in capsys.readouterr().out


def test_mesh_devices_in_the_config_selects_the_mesh(tmp_path):
    """mesh_devices > 1 asks for the sharded solve, as --devices does: the
    solve runs over a mesh of that many ranks, which is closed when the run
    returns, and gives the single-process poses."""
    rc, solver, _ = torch_cli.run(_cfg(tmp_path, "mesh", "mesh_devices=2\n"))
    assert rc == 0 and solver.mesh.size == 2 and solver.mesh.closed
    sharded = solver.state.solution
    rc, solver, _ = torch_cli.run(_cfg(tmp_path, "one", "mesh_devices=1\n"))
    assert rc == 0 and solver.mesh is None and solver.assembly is None
    np.testing.assert_allclose(sharded, solver.state.solution, atol=2e-3,
                               rtol=0)


@pytest.mark.parametrize("keys,solver_kind,dtype", [
    ('linear_solver="dense"\nassembly="jacobian"\n', "dense", "float32"),
    ('linear_solver="cg"\n', "cg", "float32"),
    ('solver_dtype="float64"\nassembly="moments"\n', "band", "float64"),
    ('lr_factor_cap=0\nauto_lc=true\n', None, "float32"),
])
def test_cli_config_keys_reach_the_solver(tmp_path, keys, solver_kind, dtype):
    rc, solver, walls = torch_cli.run(_cfg(tmp_path, "keys", keys))
    assert rc == 0 and "solve" in walls
    assert str(solver.state.problem.points.dtype) == f"torch.{dtype}"
    assert np.all(np.isfinite(solver.state.solution))
    if "assembly" in keys:
        assert solver.assembly in keys
    if solver_kind is not None:
        assert solver.last_solver == solver_kind
    else:
        # Any applied long-range closure is over a cap of 0: dense.
        lr = solver._split_lc()[1]
        assert solver.last_solver == ("dense" if lr else "band")
