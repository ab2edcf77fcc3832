"""PyTorch port: the growing-window band solve against the JAX Solver."""

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n")


def _pair(n=24, seed=0):
    js, gt = make_problem(n, "office", num_beams=180, seed=seed,
                          odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    return js, ts


@pytest.fixture(scope="module")
def solved():
    cfg = load_config_text(CFG)
    js, ts = _pair()
    jstats = JSolver(js, cfg).solve_slam()
    tstats = TSolver(ts, cfg).solve_slam()
    return cfg, js, ts, jstats, tstats


def test_solve_slam_matches_jax(solved):
    _, js, ts, jstats, tstats = solved
    assert [w.window for w in tstats.windows] == [1, 2, 3]
    for jw, tw in zip(jstats.windows, tstats.windows):
        np.testing.assert_allclose(tw.initial_cost, jw.initial_cost,
                                   rtol=1e-4)
        np.testing.assert_allclose(tw.final_cost, jw.final_cost, rtol=1e-4)
        assert tw.final_cost <= tw.initial_cost
        # The stop tests fire at float32 noise level once the cost has
        # converged, so counts are not reproducible across programs: the
        # JAX package's own fused and per-window sweeps take 6/3/5 and
        # 4/3/4 steps here.  Both engines must converge within the cap.
        assert 1 <= tw.iterations < 50
        assert abs(tw.iterations - jw.iterations) <= 4
    np.testing.assert_allclose(ts.solution, js.solution, atol=1e-4, rtol=0)


def test_solve_max_window_with_long_range_closures(solved):
    cfg, js, ts, _, _ = solved
    rng = np.random.default_rng(1)
    for (i, j) in [(2, 20), (5, 17)]:
        rel = js.solution[j] - js.solution[i] + rng.normal(scale=0.03, size=3)
        f = (i, j, rel[:2].copy(), float(rel[2]), 3.0, 3.0)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    jst = JSolver(js, cfg).solve_max_window()
    tsol = TSolver(ts, cfg)
    assert len(tsol._split_lc()[1]) == 2      # both solve as Woodbury terms
    tst = tsol.solve_max_window()
    np.testing.assert_allclose(tst.final_cost, jst.final_cost, rtol=1e-4)
    # After the first step the trial costs differ from the accepted one by
    # float32 rounding (~2e-7 of 0.64): which of those steps either engine
    # accepts is noise, and the cost is that flat over ~2e-4 of pose.
    np.testing.assert_allclose(ts.solution, js.solution, atol=1e-3, rtol=0)


def test_every_solver_route_solves_and_a_misspelt_one_raises():
    """The dense, CG and ALL routes solve, and a misspelt solver raises
    ValueError."""
    cfg = load_config_text(CFG)
    for kind in ("dense", "cg"):
        _, ts = _pair(n=8, seed=1)
        solver = TSolver(ts, cfg, linear_solver=kind)
        stats = solver.solve_slam()
        assert solver.last_solver == kind
        assert all(w.final_cost <= w.initial_cost for w in stats.windows)
    _, ts = _pair(n=8, seed=1)
    stats = TSolver(ts, cfg).solve_slam(optimization_type="all")
    assert np.isfinite(stats.final_cost)
    with pytest.raises(ValueError, match="linear_solver"):
        TSolver(ts, cfg, linear_solver="sparse")


def _with_far_odometry(state):
    """One more odometry factor, between poses 0 and 7 at their current
    relative pose: outside the window band of 3."""
    i, j, trans, rot = state.odometry_factors
    rel = state.solution[7] - state.solution[0]
    state.odometry_factors = (np.append(i, 0), np.append(j, 7),
                              np.vstack([trans, [rel[:2]]]),
                              np.append(rot, rel[2]))


def test_band_refuses_out_of_band_odometry():
    cfg = load_config_text(CFG)
    _, ts = _pair(n=8, seed=1)
    _with_far_odometry(ts)
    with pytest.raises(ValueError, match="band"):
        TSolver(ts, cfg, linear_solver="band").solve_slam()
    # 'auto' takes the dense route (it used to raise here).
    solver = TSolver(ts, cfg)
    assert not solver._odom_within_band()
    solver.solve_slam()
    assert solver.last_solver == "dense"


def _closed_pair(n_closures=3):
    js, ts = _pair()
    rng = np.random.default_rng(1)
    for k in range(n_closures):
        i, j = 2 + 2 * k, 17 + 2 * k
        rel = js.solution[j] - js.solution[i] + rng.normal(scale=0.03, size=3)
        f = (i, j, rel[:2].copy(), float(rel[2]), 3.0, 3.0)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    return js, ts


@pytest.mark.parametrize("kind,resolved", [("dense", "dense"), ("cg", "cg"),
                                           ("auto", "dense")])
def test_closures_over_the_cap_solve_as_in_jax(kind, resolved):
    """More long-range closures than lr_factor_cap: the graph is not
    band-eligible, and the whole sweep runs dense or CG, end to end against
    the JAX package on the same route."""
    cfg = load_config_text(CFG + "lr_factor_cap=2\n")
    js, ts = _closed_pair()
    jsolver = JSolver(js, cfg, linear_solver=kind)
    tsolver = TSolver(ts, cfg, linear_solver=kind)
    assert not tsolver._band_eligible() and tsolver._odom_within_band()
    assert jsolver._resolve_solver() == resolved
    jstats, tstats = jsolver.solve_slam(), tsolver.solve_slam()
    assert tsolver.last_solver == resolved
    # CG's inner solves stop on float32 dot products: JAX's own bar between
    # its dense and CG sweeps is 5e-3 on the final cost.
    rtol, atol = (5e-3, 1e-2) if resolved == "cg" else (1e-4, 1e-3)
    for jw, tw in zip(jstats.windows, tstats.windows):
        assert tw.final_cost <= tw.initial_cost * (1 + 1e-6)
        np.testing.assert_allclose(tw.final_cost, jw.final_cost, rtol=rtol)
    np.testing.assert_allclose(ts.solution, js.solution, atol=atol, rtol=0)
    with pytest.raises(ValueError, match="band"):
        TSolver(ts, cfg, linear_solver="band").solve_max_window()


@pytest.mark.parametrize("kind", ["dense", "cg", "auto"])
def test_out_of_band_odometry_solves_as_in_jax(kind):
    cfg = load_config_text(CFG)
    js, ts = _pair(n=12, seed=1)
    _with_far_odometry(js)
    _with_far_odometry(ts)
    jstats = JSolver(js, cfg, linear_solver=kind).solve_slam()
    tsolver = TSolver(ts, cfg, linear_solver=kind)
    tstats = tsolver.solve_slam()
    assert tsolver.last_solver == ("cg" if kind == "cg" else "dense")
    rtol, atol = (5e-3, 1e-2) if kind == "cg" else (1e-4, 1e-3)
    np.testing.assert_allclose(tstats.final_cost, jstats.final_cost,
                               rtol=rtol)
    np.testing.assert_allclose(ts.solution, js.solution, atol=atol, rtol=0)


def test_band_assembly_refuses_a_graph_with_long_range_closures():
    """build_graph keeps long-range closures by default, as in the JAX
    package; handing that graph to the band assembly raises ValueError
    before any block is scattered (it used to be an out-of-range index).
    With exclude_long_range the same map assembles, the closures as lr."""
    from nautilus_tpu_torch.solve.factors import assemble_banded_system
    cfg = load_config_text(CFG)
    _, ts = _closed_pair()
    solver = TSolver(ts, cfg)
    x = solver._current_x()
    graph = solver.build_graph(x, 3)
    assert graph.odom.span == 15
    with pytest.raises(ValueError, match="exclude_long_range"):
        assemble_banded_system(x, graph, solver._layout)
    in_band = solver.build_graph(x, 3, exclude_long_range=True)
    assert in_band.odom.span == 1
    system, cost = assemble_banded_system(x, in_band, solver._layout,
                                          lr=solver._long_range_factors())
    assert system.rank_lr == 9 and np.isfinite(float(cost))


def test_cg_windows_report_their_inner_iterations():
    cfg = load_config_text(CFG)
    _, ts = _pair(n=8, seed=1)
    stats = TSolver(ts, cfg, linear_solver="cg").solve_slam()
    assert all(w.inner_iterations > 0 for w in stats.windows)
    _, ts = _pair(n=8, seed=1)
    stats = TSolver(ts, cfg).solve_slam()
    assert all(w.inner_iterations == 0 for w in stats.windows)


def test_auto_resolves_cg_past_the_dense_node_limit():
    cfg = load_config_text(CFG)
    _, ts = _pair(n=8, seed=1)
    _with_far_odometry(ts)
    solver = TSolver(ts, cfg)
    assert solver._resolve_solver() == "dense"
    solver.DENSE_MAX_NODES = 4
    assert solver._resolve_solver() == "cg"
    assert TSolver.DENSE_MAX_NODES == 8000


def test_normal_gate_reaches_association():
    cfg = load_config_text(CFG)
    js, ts = _pair(n=10, seed=2)
    jg = JSolver(js, cfg, use_normal_gate=True)
    tg = TSolver(ts, cfg, use_normal_gate=True)
    graph = tg.build_graph(tg._current_x(), 3)
    jgraph = jg.build_graph(jg._current_x(), 3)
    np.testing.assert_array_equal(graph.planar.mask.numpy(),
                                  np.asarray(jgraph.planar.mask))
    np.testing.assert_array_equal(graph.edge.mask.numpy(),
                                  np.asarray(jgraph.edge.mask))
    plain = TSolver(ts, cfg).build_graph(tg._current_x(), 3)
    assert int(graph.planar.mask.sum()) <= int(plain.planar.mask.sum())
    jstats, tstats = jg.solve_slam(), tg.solve_slam()
    np.testing.assert_allclose(tstats.final_cost, jstats.final_cost,
                               rtol=1e-4)
