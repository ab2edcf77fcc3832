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


@pytest.mark.parametrize("flag", ["--vectorize", "--ros", "--devices=2"])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_cli.main(["--config_file", "x.lua", flag])
