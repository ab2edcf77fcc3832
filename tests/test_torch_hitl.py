"""PyTorch port: the HITL curation step (pose selection, factors, the
bordered band solve, the callback, the CLI) against the JAX package."""

import io
import shutil
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.core.preprocess import preprocess
from nautilus_tpu.core.problem import RawNodes, build_problem, pad_clouds
from nautilus_tpu.core.problem import SLAMState as JState
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.loop_closure.matcher import LCMatcher as JMatcher
from nautilus_tpu.solve import band as jband
from nautilus_tpu.solve import factors as jfac
from nautilus_tpu.solve import hitl as jhitl
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.io.poses import read_pose_file
from nautilus_tpu_torch.loop_closure.matcher import LCMatcher
from nautilus_tpu_torch.solve import band as tband
from nautilus_tpu_torch.solve import factors as tfac
from nautilus_tpu_torch.solve import hitl as thitl
from nautilus_tpu_torch.solve.lm import LMParams
from nautilus_tpu_torch.solve.solver import Solver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n"
       "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n")
# The curation case HITL exists for: on the 24-pose office map, poses 12-23
# drift 0.3 m in y, so the right half of the y = -2 wall shows twice.  Line
# A is drawn on its true place (poses 0-11 see it), line B on the copy
# (poses 12-17).
SHIFT = 0.3
LINES = ((2.0, -2.0), (10.0, -2.0), (2.0, -2.0 + SHIFT), (10.0, -2.0 + SHIFT))


def _port_state(js):
    """The port's state on exactly the JAX state's problem arrays."""
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    return ts


def _office(solve):
    """The JAX and the port's state of the 24-pose office map, solved by
    both engines if ``solve``, then with poses 12-23 shifted by SHIFT in y.
    Returns (cfg, js, ts, jsolver, tsolver)."""
    cfg = load_config_text(CFG)
    js, _ = make_problem(24, "office", num_beams=180, seed=0,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    ts = _port_state(js)
    jsol, tsol = JSolver(js, cfg), Solver(ts, cfg)
    if solve:
        jsol.solve_slam()
        tsol.solve_slam()
    for s in (js, ts):
        s.solution[12:, 1] += SHIFT
    return cfg, js, ts, jsol, tsol


def _msgs(points):
    return (jhitl.HitlSlamInputMsg.from_points(*points),
            thitl.HitlSlamInputMsg.from_points(*points))


# -- pose selection ----------------------------------------------------------

SELECT_CFG = ("hitl_line_width=0.1\nhitl_pose_point_threshold=10\n")


def _wall_states(shift):
    """tests/test_hitl.py's scenario: two nodes each seeing the wall y = 0
    in their own frames, node 1 shifted by +shift in y."""
    xs = np.linspace(0.0, 4.0, 80)
    wall = np.stack([xs, np.zeros_like(xs)], -1).astype(np.float32)
    points, mask = pad_clouds([wall, wall.copy()])
    raw = RawNodes(
        points=points, points_mask=mask,
        initial_poses=np.array([[0, 0, 0], [0.0, shift, 0]], np.float64),
        timestamps=np.array([1.0, 2.0]),
        odom_i=np.array([0]), odom_j=np.array([1]),
        odom_trans=np.array([[0.0, shift]]), odom_rot=np.array([0.0]))
    normals, pi, pm, ei, em, _ = preprocess(raw.points, raw.points_mask)
    js = JState.from_problem(build_problem(raw, normals, pi, pm, ei, em),
                             raw.timestamps)
    return js, _port_state(js)


@pytest.mark.parametrize("shift,lines,a_nodes,b_nodes", [
    # One wall per line.
    (0.4, ((-0.5, 0.0), (4.5, 0.0), (-0.5, 0.4), (4.5, 0.4)), [0], [1]),
    # Both walls within the width of line A: else-if, both poses join A.
    (0.05, ((-0.5, 0.0), (4.5, 0.0), (-0.5, 0.05), (4.5, 0.05)), [0, 1], []),
    # Node 1's wall far from both lines: below the point threshold.
    (5.0, ((-0.5, 0.0), (4.5, 0.0), (-0.5, 0.4), (4.5, 0.4)), [0], []),
])
def test_select_poses_matches_jax(shift, lines, a_nodes, b_nodes):
    cfg = load_config_text(SELECT_CFG)
    js, ts = _wall_states(shift)
    jmsg, tmsg = _msgs(lines)
    jc = jhitl.select_poses(js, jmsg, cfg)
    tc = thitl.select_poses(ts, tmsg, cfg)
    for jp, tp, expect in ((jc.line_a_poses, tc.line_a_poses, a_nodes),
                           (jc.line_b_poses, tc.line_b_poses, b_nodes)):
        assert [k for k, _ in tp] == [k for k, _ in jp] == expect
        for (_, jpts), (_, tpts) in zip(jp, tp):
            np.testing.assert_array_equal(tpts, jpts)
    assert tc.line_pose_index == 0


def test_solved_odometry_matches_jax():
    js, _ = make_problem(7, "room", num_beams=180, seed=1)
    ts = _port_state(js)
    for a, b in zip(thitl.solved_odom_factors(ts, 3),
                    jhitl.solved_odom_factors(js, 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(thitl.solved_odom_factors_between(ts, 1, 5),
                    jhitl.solved_odom_factors_between(js, 1, 5)):
        np.testing.assert_array_equal(a, b)
    trans = np.array([[0.5, 0.1], [0.2, -0.3], [0.0, 0.4]])
    rot = np.array([3.0, 2.0, -1.0])
    t1, r1 = thitl.total_odom_change(trans, rot)
    t2, r2 = jhitl.total_odom_change(trans, rot)
    np.testing.assert_array_equal(t1, t2)
    assert r1 == r2


# -- factors and the bordered band system -------------------------------------

@pytest.fixture(scope="module")
def bordered():
    """One 24-pose office graph with a HITL constraint on both lines, the
    line pose moved off zero, and one long-range loop closure, in both
    engines."""
    cfg, js, ts, jsol, tsol = _office(solve=False)
    jmsg, tmsg = _msgs(LINES)
    js.hitl_constraints.append(jhitl.select_poses(js, jmsg, cfg))
    ts.hitl_constraints.append(thitl.select_poses(ts, tmsg, cfg))
    line_pose = np.array([[0.05, -0.03, 0.01]])
    js.line_poses = ts.line_poses = line_pose
    rel = js.solution[20] - js.solution[2]
    for s in (js, ts):
        s.lc_factors.append((2, 20, rel[:2] + 0.02, float(rel[2]), 2.0, 1.5))
    x = np.concatenate([js.solution, line_pose]).astype(np.float32)
    jgraph = jsol.build_graph(jnp.asarray(x), 3, exclude_long_range=True)
    tgraph = tsol.build_graph(torch.as_tensor(x), 3)
    jsys, jcost = jfac.assemble_banded_system(
        jnp.asarray(x), jgraph, jsol._layout, True, jsol._long_range_factors())
    tsys, tcost = tfac.assemble_banded_system(
        torch.as_tensor(x), tgraph, tsol._layout, True,
        tsol._long_range_factors())
    return (js, ts, jsol, tsol, x, jgraph, tgraph, jsys, jcost, tsys, tcost)


def test_constraint_selects_both_lines(bordered):
    js, ts = bordered[:2]
    tc = ts.hitl_constraints[0]
    assert [k for k, _ in tc.line_a_poses] == list(range(12))
    assert [k for k, _ in tc.line_b_poses] == list(range(12, 18))
    rows = thitl.build_hitl_factors(ts)
    jrows = jhitl.build_hitl_factors(js)
    r = rows.node.shape[0]
    assert r == 18
    # JAX pads rows and points to power-of-two buckets with masked zeros.
    np.testing.assert_array_equal(rows.node.numpy(), np.asarray(jrows.node)[:r])
    np.testing.assert_array_equal(rows.line.numpy(), np.asarray(jrows.line)[:r])
    k = rows.points.shape[1]
    np.testing.assert_array_equal(rows.points.numpy(),
                                  np.asarray(jrows.points)[:r, :k])
    np.testing.assert_array_equal(rows.mask.numpy(),
                                  np.asarray(jrows.mask)[:r, :k])
    assert not np.asarray(jrows.mask)[:r, k:].any()
    np.testing.assert_array_equal(rows.seg_start.numpy(),
                                  np.asarray(jrows.seg_start)[:r])


def test_hitl_linearization_matches_jax(bordered):
    js, ts, jsol, tsol, x, jgraph, tgraph = bordered[:7]
    spec = tfac.hitl_factor_spec(tgraph)
    r, J = tfac.linearize_two_pose_jacfwd(torch.as_tensor(x), *spec)
    jr, jJ, _ = jfac.linearize_two_pose_jacfwd(jnp.asarray(x),
                                               *jfac.hitl_factor_spec(jgraph))
    q, k = r.shape
    assert np.asarray(jr)[q:].max() == 0              # JAX's padded rows
    # Same float32 geometry; jacfwd tangents in two frameworks.
    np.testing.assert_allclose(r.numpy(), np.asarray(jr)[:q, :k], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ)[:q, :k], rtol=1e-4,
                               atol=1e-5)


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1.0))


def test_bordered_assembly_matches_jax(bordered):
    jsys, jcost, tsys, tcost = bordered[7:]
    assert tsys.num_lines == jsys.num_lines == 1
    # Float32 sums in another order: tolerance relative to the largest entry.
    for name in ("diag", "band", "g", "C", "E", "gl"):
        _close(getattr(tsys, name), getattr(jsys, name), 1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-4)
    # The graph's cost leaves out the long-range closure, as does assembly
    # without its Woodbury columns.
    tsol, x, tgraph = bordered[3], torch.as_tensor(bordered[4]), bordered[6]
    np.testing.assert_allclose(
        float(tfac.total_cost(x, tgraph)),
        float(tfac.assemble_banded_system(x, tgraph, tsol._layout)[1]),
        rtol=1e-5)


def _dense_bordered(sys, fixed, radius, params):
    """The damped gauged bordered system solved densely in float64."""
    n, L = sys.n, sys.num_lines
    H = torch.zeros((3 * (n + L), 3 * (n + L)), dtype=torch.float64)
    H[:3 * n, :3 * n] = tfac._band_to_dense(
        sys.diag.double(), sys.band.double(), tfac.BandLayout(n, sys.w))
    if sys.U is not None:
        H[:3 * n, :3 * n] += sys.U.double() @ sys.U.double().T
    C2 = sys.C.double().permute(0, 2, 1, 3).reshape(3 * n, 3 * L)
    H[:3 * n, 3 * n:] = C2
    H[3 * n:, :3 * n] = C2.T
    H[3 * n:, 3 * n:] = torch.block_diag(*sys.E.double().unbind(0))
    g = torch.cat([sys.g.double().reshape(-1), sys.gl.double().reshape(-1)])
    free = ~fixed
    Hg = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
    Hg = Hg + torch.diag(fixed.double())
    g = torch.where(free, g, torch.zeros_like(g))
    d = torch.clamp(torch.diagonal(Hg), params.min_diagonal,
                    params.max_diagonal)
    d = torch.where(fixed, torch.zeros_like(d), d)
    return torch.linalg.solve(Hg + torch.diag(d / radius), -g).reshape(-1, 3)


def test_border_solve_matches_dense_f64_and_jax(bordered):
    jsol, tsol = bordered[2:4]
    jsys, tsys = bordered[7], bordered[9]
    fixed = tsol._fixed_mask()
    assert fixed.shape == (3 * 25,)
    params = LMParams()
    step, sysg, ok = tband.solve_damped_banded(tsys, fixed, torch.tensor(1e2),
                                               params)
    assert bool(ok) and step.shape == (25, 3)
    ref = _dense_bordered(tsys, fixed, 1e2, params)
    # Float32 band Cholesky + Schur step against float64 dense.
    assert float((step.double() - ref).abs().max() / ref.abs().max()) < 1e-4
    assert torch.all(step[0] == 0)
    jdx, jdxl, _ = jband.solve_damped_banded(
        jsys, jnp.asarray(fixed.numpy()), 1e2, params)
    j_step = np.concatenate([np.asarray(jdx), np.asarray(jdxl)])
    _close(step.numpy(), j_step, 2e-4)
    # The matvec of the bordered system against the dense one.
    H_step = tband.band_matvec(sysg, step)
    jH, jHl = jband.band_matvec(jband._apply_gauge_band(
        jsys, jnp.asarray(fixed.numpy())), jnp.asarray(step[:24].numpy()),
        jnp.asarray(step[24:].numpy()))
    _close(H_step.numpy(), np.concatenate([np.asarray(jH), np.asarray(jHl)]),
           1e-5)


def test_band_inverse_node_columns_with_lines_matches_jax(bordered):
    jsys, tsys = bordered[7], bordered[9]
    fixed_np = np.repeat(np.arange(25) == 3, 3)      # the line pose is free
    cols = np.array([0, 4, 17, 30, 50, 71], np.int64)
    jX = np.asarray(jband.band_inverse_node_columns(
        jsys, jnp.asarray(fixed_np), jnp.asarray(cols, jnp.int32)))
    tX = tband.band_inverse_node_columns(
        tsys, torch.as_tensor(fixed_np), torch.as_tensor(cols)).numpy()
    assert tX.shape == (72, 6)
    # The tolerance of the border-free test in test_torch_factors_band.py.
    np.testing.assert_allclose(tX, jX, rtol=2e-3,
                               atol=2e-3 * np.abs(jX).max())


# -- the curation step end to end ---------------------------------------------

@pytest.fixture(scope="module")
def curated():
    cfg, js, ts, jsol, tsol = _office(solve=True)
    solved = ts.solution.copy()
    jmsg, tmsg = _msgs(LINES)
    jstats = jhitl.hitl_callback(jsol, jmsg, verbose=False)
    tstats = thitl.hitl_callback(tsol, tmsg, verbose=False)
    return cfg, js, ts, jsol, tsol, jstats, tstats, solved


def test_hitl_callback_matches_jax(curated):
    _, js, ts, _, _, jstats, tstats, _ = curated
    tc, jc = ts.hitl_constraints[0], js.hitl_constraints[0]
    assert [k for k, _ in tc.line_a_poses] == [k for k, _ in jc.line_a_poses]
    assert [k for k, _ in tc.line_b_poses] == [k for k, _ in jc.line_b_poses]
    assert tc.line_b_poses
    for jst, tst in zip(jstats, tstats):
        assert [w.window for w in tst.windows] == [1, 2, 3]
        for jw, tw in zip(jst.windows, tst.windows):
            np.testing.assert_allclose(tw.initial_cost, jw.initial_cost,
                                       rtol=1e-4)
            np.testing.assert_allclose(tw.final_cost, jw.final_cost,
                                       rtol=1e-4)
    # LM stops on float32 noise once converged: poses agree to the spread
    # of the JAX package's own two sweeps (4.3e-4 m), not to bits.
    np.testing.assert_allclose(ts.solution, js.solution, atol=5e-4, rtol=0)
    np.testing.assert_allclose(ts.line_poses, np.asarray(js.line_poses),
                               atol=5e-4, rtol=0)
    assert ts.line_poses.shape == (1, 3)
    assert ts.odometry_factors is ts.initial_odometry_factors


def test_hitl_lowers_its_residual_cost(curated):
    """The curation step pulls the selected walls onto the line."""
    _, _, ts, _, _, _, _, solved = curated
    start = SLAMState(problem=ts.problem, solution=solved,
                      timestamps=ts.timestamps,
                      hitl_constraints=ts.hitl_constraints,
                      line_poses=np.zeros((1, 3)))
    before, after = thitl.hitl_cost(start), thitl.hitl_cost(ts)
    assert np.all(np.isfinite(ts.solution))
    assert 0.0 < after < before, (before, after)


def test_gate_on_a_curated_state_matches_jax(curated):
    """Auto-LC's chi-square gate with a line pose in the system."""
    _, js, ts, jsol, tsol, _, _, _ = curated
    pairs = [(20, 2), (22, 5), (15, 3)]
    jm = JMatcher.from_solver(jsol)
    tm = LCMatcher.from_solver(tsol)
    assert tm._sys.num_lines == 1
    for s, t in pairs:
        jcov, jscore = jm.chi_square_score(s, t)
        tcov, tscore = tm.chi_square_score(s, t)
        np.testing.assert_allclose(tcov, jcov, rtol=2e-3,
                                   atol=2e-3 * np.abs(jcov).max())
        np.testing.assert_allclose(tscore, jscore, rtol=5e-3)


# -- the CLI ------------------------------------------------------------------

CLI_CFG = """
dofile("default_config.lua")
pose_number=16
lidar_constraint_amount_max=3
hitl_line_width=0.3
pose_output_file="{poses}"
"""
CLI_LINE = "-5 -5 5 -5 -5 5 5 5"


def _cli(tmp_path, name, extra, stdin=None, monkeypatch=None):
    shutil.copy(Path(__file__).resolve().parents[1] / "config"
                / "default_config.lua", tmp_path / "default_config.lua")
    cfg = tmp_path / f"{name}.lua"
    poses = tmp_path / f"{name}_poses.txt"
    cfg.write_text(CLI_CFG.format(poses=poses))
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = torch_cli.main(["--config_file", str(cfg), "--synthetic", "room",
                         "--synthetic_seed", "2", "--device", "cpu",
                         "--quiet", *extra])
    assert rc == 0
    return cfg, poses


def test_cli_hitl_replay_matches_library_call(tmp_path):
    replay = tmp_path / "lines.txt"
    replay.write_text(f"# one curation step\n\n{CLI_LINE}\n")
    cfg, poses = _cli(tmp_path, "replay",
                      ["--hitl_replay", str(replay), "--write"])
    got = np.stack(list(read_pose_file(poses).values()))

    from nautilus_tpu_torch.core.luaconf import load_config
    from nautilus_tpu_torch.ingest.synthetic import make_problem as tmake

    conf = load_config(cfg)
    state, _ = tmake(16, "room", seed=2, device="cpu")
    solver = Solver(state, conf)
    solver.solve_slam()
    thitl.hitl_callback(solver, thitl.HitlSlamInputMsg.from_points(
        *np.array(CLI_LINE.split(), float).reshape(4, 2)), verbose=False)
    assert state.hitl_constraints[0].line_a_poses
    # The pose file keeps 6 decimals.
    np.testing.assert_allclose(got, state.solution, atol=1e-6, rtol=0)


def test_cli_interactive_loop(tmp_path, monkeypatch, capsys):
    _, poses = _cli(tmp_path, "interactive", ["--interactive"],
                    stdin=(f"hitl {CLI_LINE}\nhitl 1 2 3\nvectorize\n"
                           "bogus\nwrite\nquit\nwrite\n"),
                    monkeypatch=monkeypatch)
    out = capsys.readouterr().out
    assert "Error: hitl needs 8 floats" in out
    assert "Error: vectorize is not yet ported (ROADMAP.md" in out
    assert "Unknown command: bogus" in out
    assert out.count("Wrote poses") == 1       # nothing runs after quit
    assert len(read_pose_file(poses)) == 16
