"""The curation cell ``lgrc2019.hitl_session``: the harness finds its files
by name, its configuration holds the Lua file's keys, the plain reference
of the curation step computes the port's densified odometry and
point-to-segment rows, and a run with a fault planted in the program comes
out not correct.

The runs here are on the CPU at a reduced size: the configuration file's
keys in float64, 170 poses with 360 beams in the 20 x 20 m office world,
whose trajectory closes its loop after 151 poses, and two line pairs that
the cell's line-pair maker (portbench/line_pairs.py) draws there on the
reference's maps.  Line B's rows dropped, the other fault the reference
must catch, is planted by tests/test_torch_hitl_reference.py.  In
float64 the program and the reference agree far inside the cell's limits,
so the sound run is correct and each fault alone decides the verdict.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import curation, line_pairs, program, traffic  # noqa: E402
from portbench import run as harness  # noqa: E402
from portbench.reference import curation as ref  # noqa: E402
from portbench.tests import hitl_faults  # noqa: E402

CELL = "lgrc2019.hitl_session"
SEED = 2 ** 31 + 5151
DRIFT = 2019110101


def _cell():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    return (bench,) + harness.cell_files(bench, CELL)


@pytest.fixture(scope="module")
def small():
    """(configuration, mix) at the reduced size, with its drawn pairs."""
    _, _, conf, mix = _cell()
    conf = copy.deepcopy(conf)
    conf["keys"].update(pose_number=170, solver_dtype="float64")
    conf["inputs"].update(world="office", num_beams=360)
    pairs, notes, _ = line_pairs.draw(conf, DRIFT, 2)
    assert len(pairs) == 2, notes
    return conf, dict(mix, drifts=[DRIFT], line_pairs={str(DRIFT): pairs})


def test_the_cell_resolves_by_name():
    bench, cell, conf, mix = _cell()
    assert conf["name"] == cell["config"] == "lgrc2019"
    assert mix["kind"] == "hitl_session"
    assert callable(harness.kind(mix["kind"]))
    limits = harness.load_json(harness.BENCH / "limits" / f"{CELL}.json")
    assert set(limits) == {"sweep_gap", "select_miss", "hitl_gap"}
    names = [m["name"] for m in harness.per_layer(bench, CELL)]
    assert names == ["hitl.step_s", "hitl.select_s", "hitl.lm_steps",
                     "hitl.selected_poses"]
    for name in names:
        assert harness.reader(name)(traffic.Run("map_s")) is None
    assert [m["name"] for m in harness.end_to_end(bench, CELL)] \
        == ["setup_s", "map_s"]
    for d in mix["drifts"]:
        pairs = mix["line_pairs"][str(d)]
        assert 1 <= len(pairs) <= line_pairs.PAIRS
        assert all(len(p) == 8 for p in pairs)


def test_the_configuration_holds_the_lua_keys():
    from nautilus_tpu_torch.core.luaconf import load_config
    bench, _, conf, _ = _cell()
    source = load_config(ROOT / "config" / "lgrc_bag_config.lua").values
    assert conf["keys"] == source
    assert conf["reduced"] == [] == next(
        c["reduced"] for c in bench["configs"] if c["name"] == "lgrc2019")


@pytest.fixture(scope="module")
def curated(small):
    """The port's state after the small session's two steps, and them."""
    conf, mix = small
    scans = traffic.scans(conf, [DRIFT])[0]
    cfg = program.config(conf["keys"], "lgrc2019")
    sv, solves = curation.swept(scans, cfg, "cpu")
    steps = curation.curate(sv, solves, mix["line_pairs"][str(DRIFT)])
    return sv.state, steps


def test_densified_odometry_is_the_ports(curated):
    from nautilus_tpu_torch.solve.hitl import solved_odom_factors
    state, _ = curated
    i, j, trans, rot = solved_odom_factors(state, 10)
    want = ref.densified_odometry(state.solution, 10, 1.0, 1.0)
    np.testing.assert_array_equal(want.i, i)
    np.testing.assert_array_equal(want.j, j)
    np.testing.assert_allclose(want.trans, trans, rtol=1e-12, atol=0)
    np.testing.assert_allclose(want.rot, rot, rtol=1e-12, atol=0)


def test_point_to_segment_rows_are_the_ports(curated):
    from nautilus_tpu_torch.solve import factors, hitl
    state, steps = curated
    rows = ref.rows_of([ref.Constraint(s.seg_a, s.nodes_a + s.nodes_b,
                                       s.points) for s in steps])
    x = torch.as_tensor(state.solution)
    lines = torch.as_tensor(state.line_poses)
    r_ref, J_ref = ref.hitl_rows(x, lines, rows)
    got = hitl.build_hitl_factors(state, torch.float64)
    spec = factors.hitl_factor_spec(
        factors.FactorGraph(None, None, None, got))
    r, J = factors.linearize_two_pose_jacfwd(torch.cat([x, lines]), *spec)
    assert r.shape == r_ref.shape and float(torch.max(r_ref)) > 0
    np.testing.assert_allclose(r.numpy(), r_ref.numpy(), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(J.reshape(J_ref.shape).numpy(),
                               J_ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fault,caught_by", [
    (None, None), (hitl_faults.fixed_line_pose, "hitl_gap"),
    (hitl_faults.wide_selection, "select_miss"),
    (hitl_faults.window_short, "sweep_gap")])
def test_a_planted_fault_is_not_correct(small, monkeypatch, fault,
                                        caught_by):
    conf, mix = small
    if fault is not None:
        fault(monkeypatch)
    run, judge = harness.kind(mix["kind"])(mix, conf, SEED, 0.1, False,
                                           "cpu", 0.0)
    limits = harness.load_json(harness.BENCH / "limits" / f"{CELL}.json")
    checks = judge(step=1)
    correct, shown = harness.verdict(run, checks, limits)
    assert correct == (fault is None), shown
    if caught_by:
        assert not checks[caught_by] <= limits[caught_by], shown
