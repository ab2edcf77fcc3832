"""PyTorch port: dense normal equations, the dense LM loop and the dense
covariance engine against the JAX package, on the same numpy inputs."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.loop_closure import matcher as jmatcher
from nautilus_tpu.solve import factors as jfac
from nautilus_tpu.solve import lm as jlm
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.loop_closure import matcher as tmatcher
from nautilus_tpu_torch.solve import factors as tfac
from nautilus_tpu_torch.solve import lm as tlm
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\n")


def _pair(n=16, seed=2, closures=((1, 12), (3, 14))):
    """The same problem in both packages, with long-range closures."""
    js, _ = make_problem(n, "building", num_beams=240, seed=seed,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    rng = np.random.default_rng(seed)
    for (i, j) in closures:
        rel = js.solution[j] - js.solution[i] + rng.normal(scale=0.03, size=3)
        f = (i, j, rel[:2].copy(), float(rel[2]), 3.0, 3.0)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    return js, ts


@pytest.fixture(scope="module")
def graphs():
    cfg = load_config_text(CFG)
    js, ts = _pair()
    jsol, tsol = JSolver(js, cfg), TSolver(ts, cfg)
    jx, tx = jsol._current_x(), tsol._current_x()
    return (jsol, jx, jsol.build_graph(jx, 3)), \
        (tsol, tx, tsol.build_graph(tx, 3))


@pytest.mark.parametrize("with_layout", [False, True])
def test_assemble_normal_equations_matches_jax(graphs, with_layout):
    (jsol, jx, jg), (tsol, tx, tg) = graphs
    jH, jgr, jc = jfac.assemble_normal_equations(
        jx, jg, jsol._layout if with_layout else None)
    H, g, c = tfac.assemble_normal_equations(
        tx, tg, tsol._layout if with_layout else None)
    # Float32 sums of the same 6x6 blocks in another order.
    scale = float(np.abs(np.asarray(jH)).max())
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    np.testing.assert_allclose(H.numpy(), H.numpy().T, atol=1e-5 * scale)
    # The long-range closures couple poses outside the band.
    assert abs(float(H[3 * 1, 3 * 12])) > 0


def test_dense_layout_and_scatter_paths_agree(graphs):
    _, (tsol, tx, tg) = graphs
    H0, g0, c0 = tfac.assemble_normal_equations(tx, tg, None)
    H1, g1, c1 = tfac.assemble_normal_equations(tx, tg, tsol._layout)
    H2, g2, c2 = tfac.assemble_normal_equations(tx, tg, tsol._layout,
                                                "moments")
    for H, g, c in ((H1, g1, c1), (H2, g2, c2)):
        torch.testing.assert_close(H, H0, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(g, g0, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(c, c0, rtol=1e-5, atol=0)


def test_moments_and_jacobian_band_assembly_agree_with_jax(graphs):
    """factors._factor_blocks serves both forms (Solver assembly='moments' /
    'jacobian'): each against the other, and against the JAX package's."""
    (jsol, jx, _), (tsol, tx, _) = graphs
    jg = jsol.build_graph(jx, 3, exclude_long_range=True)
    tg = tsol.build_graph(tx, 3, exclude_long_range=True)
    out = {}
    for name, analytic in (("moments", "moments"), ("jacobian", True)):
        sys_, c = tfac.assemble_banded_system(tx, tg, tsol._layout, analytic)
        jsys, jc = jfac.assemble_banded_system(jx, jg, jsol._layout, analytic)
        out[name] = (sys_, c)
        scale = float(np.abs(np.asarray(jsys.diag)).max())
        np.testing.assert_allclose(sys_.diag.numpy(), np.asarray(jsys.diag),
                                   rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(sys_.band.numpy(), np.asarray(jsys.band),
                                   rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(sys_.g.numpy(), np.asarray(jsys.g),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    (sm, cm), (sj, cj) = out["moments"], out["jacobian"]
    torch.testing.assert_close(sm.diag, sj.diag, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(sm.band, sj.band, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(sm.g, sj.g, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cm, cj, rtol=1e-5, atol=0)


def test_solver_assembly_option_selects_the_form():
    cfg = load_config_text(CFG)
    _, ts = _pair(n=8, closures=())
    assert TSolver(ts, cfg)._analytic_mode() == "moments"
    assert TSolver(ts, cfg, assembly="moments")._analytic_mode() == "moments"
    assert TSolver(ts, cfg, assembly="jacobian")._analytic_mode() is True
    with pytest.raises(ValueError, match="assembly"):
        TSolver(ts, cfg, assembly="sparse")
    finals = {}
    for assembly in ("moments", "jacobian"):
        _, ts = _pair(n=8, closures=())
        finals[assembly] = TSolver(ts, cfg,
                                   assembly=assembly).solve_slam().final_cost
    assert finals["jacobian"] == pytest.approx(finals["moments"], rel=1e-4)


@pytest.mark.parametrize("with_layout", [False, True])
def test_lm_solve_matches_jax(graphs, with_layout):
    (jsol, jx, jg), (tsol, tx, tg) = graphs
    jres = jlm.lm_solve(jx, jg, jsol._fixed_mask(),
                        layout=jsol._layout if with_layout else None)
    tres = tlm.lm_solve(tx, tg, tsol._fixed_mask(),
                        layout=tsol._layout if with_layout else None)
    assert tres.cost < tres.initial_cost
    np.testing.assert_allclose(tres.initial_cost, float(jres.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(tres.cost, float(jres.cost), rtol=1e-4)
    # Which noise-level steps either engine accepts once converged differs.
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tres.x.numpy()[0], tx.numpy()[0])  # gauge


def test_dense_lm_rejects_a_failed_cholesky():
    """An indefinite H fails its factorization at every radius: each step
    is rejected, x stays, and the loop ends on the radius floor."""
    x0 = torch.zeros((2, 3))
    H = -torch.eye(6)
    res = tlm.lm_loop(
        x0, assemble_fn=lambda x: (H, torch.ones(6), torch.tensor(1.0)),
        cost_fn=lambda x: torch.tensor(0.5),
        fixed_dof=tlm.fixed_pose_mask(6),
        params=tlm.LMParams(max_iterations=8))
    assert res.iterations == 8 and not res.converged
    assert torch.equal(res.x, x0) and res.cost == 1.0
    _, _, _, ok = tlm._solve_damped(H, torch.ones(6), tlm.fixed_pose_mask(6),
                                    torch.tensor(1e4), tlm.LMParams())
    assert not bool(ok)


def test_fixed_pose_mask():
    m = tlm.fixed_pose_mask(9, fixed_pose=1)
    assert m.tolist() == [False] * 3 + [True] * 3 + [False] * 3
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jlm.fixed_pose_mask(9, 1)))


def test_cross_cov_blocks_match_jax_and_the_band_engine(graphs):
    (jsol, jx, jg), (tsol, tx, tg) = graphs
    ss, tt = [9, 12, 4], [2, 5, 13]
    jH, _, _ = jfac.assemble_normal_equations(jx, jg)
    jb = np.asarray(jmatcher._cross_cov_blocks(
        jH, 1, jnp.asarray(ss, jnp.int32), jnp.asarray(tt, jnp.int32)))
    H, _, _ = tfac.assemble_normal_equations(tx, tg)
    tb = tmatcher._cross_cov_blocks(H, 1, torch.as_tensor(ss),
                                    torch.as_tensor(tt)).numpy()
    # Entries of a float32 inverse: relative to the largest block entry.
    np.testing.assert_allclose(tb, jb, rtol=2e-3, atol=2e-3 * np.abs(jb).max())
    # The band engine on the same state (closures as Woodbury columns).
    bg = tsol.build_graph(tx, 3, exclude_long_range=True)
    sys_, _ = tfac.assemble_banded_system(tx, bg, tsol._layout, True,
                                          tsol._long_range_factors())
    bb = tmatcher._cross_cov_blocks_band(sys_, 1, torch.as_tensor(ss),
                                         torch.as_tensor(tt)).numpy()
    np.testing.assert_allclose(tb, bb, rtol=2e-3, atol=2e-3 * np.abs(bb).max())


def test_failed_covariance_factorization_scores_infinite():
    H = -torch.eye(9)
    blocks = tmatcher._cross_cov_blocks(H, 0, torch.as_tensor([1]),
                                        torch.as_tensor([2]))
    assert bool(torch.isnan(blocks).all())
    cfg = load_config_text(CFG)
    _, ts = _pair(n=8, closures=())
    m = tmatcher.LCMatcher.from_solver(TSolver(ts, cfg))
    m._sys, m.H = None, -torch.eye(24)
    with pytest.warns(UserWarning, match="factorization"):
        _, score = m.chi_square_score(5, 2)
    assert score == float("inf")
    assert m.get_possible_matches(5, [2]) == []


def test_matcher_takes_the_dense_engine_past_the_cap():
    cfg = load_config_text(CFG + "lr_factor_cap=1\n")
    js, ts = _pair()
    jm = jmatcher.LCMatcher.from_solver(JSolver(js, cfg))
    tm = tmatcher.LCMatcher.from_solver(TSolver(ts, cfg))
    assert tm.H is not None and tm._sys is None and jm.H is not None
    band = tmatcher.LCMatcher.from_solver(
        TSolver(ts, load_config_text(CFG)))
    assert band.H is None and band._sys is not None
    for s, t in [(10, 2), (13, 6), (7, 0)]:
        jcov, jscore = jm.chi_square_score(s, t)
        tcov, tscore = tm.chi_square_score(s, t)
        _, bscore = band.chi_square_score(s, t)
        np.testing.assert_allclose(tcov, jcov, rtol=2e-3,
                                   atol=2e-3 * np.abs(jcov).max())
        assert tscore == pytest.approx(jscore, rel=5e-3)
        assert tscore == pytest.approx(bscore, rel=5e-3)


def _score_and_block_errors(got, want):
    """Largest relative chi-square error over the pairs, and the largest
    covariance block error relative to the block's largest entry."""
    (s_got, c_got), (s_want, c_want) = got, want
    score = np.max(np.abs(s_got - s_want) / np.abs(s_want))
    block = np.max(np.abs(c_got - c_want).max((1, 2))
                   / np.abs(c_want).max((1, 2)))
    return float(score), float(block)


def test_float32_band_covariance_error_is_the_designs():
    """The float32 band + Woodbury covariance engine's error against a
    float64 dense referee, for the JAX package and for the port, on a
    200-pose building closed by 8 long-range closures: the port's error is
    within twice JAX's, so the error is the float32 design's, not the
    port's.  At 1000 poses the same engine is ~1e-2 off on the card."""
    import jax
    from nautilus_tpu.core.luaconf import load_config as jload_config
    from nautilus_tpu.ingest.synthetic import synthesize
    cfg = jload_config("config/default_config.lua")
    n = 200
    _, gt = synthesize(num_nodes=n, world_kind="building", seed=1,
                       num_beams=16)
    w = cfg.get_int("lidar_constraint_amount_max")
    # Closures between the 8 nearest pose pairs more than 2w apart (the
    # loop's two ends), at their true relative pose.
    d = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
    d[np.arange(n)[None] - np.arange(n)[:, None] <= 2 * w] = np.inf
    closures = []
    for k in np.argsort(d, axis=None):
        i, j = divmod(int(k), n)
        if all(abs(i - a) > 5 for a, *_ in closures):
            rel = gt[j] - gt[i]
            closures.append((i, j, rel[:2].copy(), float(rel[2]), 2.0, 1.5))
        if len(closures) == 8:
            break
    # Pairs in 4 gauge groups, spanning the graph.
    pairs = [(t + gap, t) for t in (10, 50, 90, 130)
             for gap in range(25, 70, 6)]

    def scored(matcher):
        out = [matcher.chi_square_score(s, t) for s, t in pairs]
        return (np.array([o[1] for o in out]),
                np.array([np.asarray(o[0], np.float64) for o in out]))

    js, _ = make_problem(n, "building", num_beams=240, seed=1)
    js.solution = gt.copy()
    js.lc_factors = list(closures)
    jband = jmatcher.LCMatcher.from_solver(JSolver(js, cfg))
    assert jband._sys is not None
    jax_band = scored(jband)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = gt.copy()
    ts.lc_factors = list(closures)
    tband = tmatcher.LCMatcher.from_solver(TSolver(ts, cfg))
    assert tband._sys is not None and tband._sys.U is not None
    port_band = scored(tband)
    jax.config.update("jax_enable_x64", True)
    try:
        # The same clouds and odometry, cast to float64.
        js64 = dataclasses.replace(js, lc_factors=list(closures),
                                   problem=js.problem._replace(**{
                                       f: jnp.asarray(arrays[f], jnp.float64)
                                       for f in ("points", "normals",
                                                 "initial_poses",
                                                 "odom_trans", "odom_rot")}))
        referee = jmatcher.LCMatcher.from_solver(JSolver(
            js64, cfg.replace(lr_factor_cap=0)))
        assert referee.H is not None and referee.H.dtype == jnp.float64
        f64 = scored(referee)
    finally:
        jax.config.update("jax_enable_x64", False)
    # A cross-covariance block may be indefinite: scores of either sign.
    assert np.all(np.isfinite(f64[0])) and np.all(np.abs(f64[0]) > 1)
    jax_err = _score_and_block_errors(jax_band, f64)
    port_err = _score_and_block_errors(port_band, f64)
    print(f"float32 band engine vs float64 dense (chi-square, block): "
          f"JAX {jax_err}, port {port_err}")
    assert max(jax_err) > 1e-5          # float32's error, not zero
    for ours, theirs in zip(port_err, jax_err):
        assert ours <= 2 * theirs
