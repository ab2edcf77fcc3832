"""PyTorch port: solver_dtype=float64 against the JAX package's x64 run, on
the same numpy inputs.  In doubles the two engines agree to ~1e-9 relative
where float32 gave 1e-4 to 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem as jax_make_problem
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import (SLAMState, problem_from_numpy,
                                             resolve_solver_dtype)
from nautilus_tpu_torch.ingest.synthetic import make_problem
from nautilus_tpu_torch.kernels.csm import CSMParams, csm_match_pairs
from nautilus_tpu_torch.loop_closure.matcher import LCMatcher
from nautilus_tpu_torch.solve import hitl as thitl
from nautilus_tpu_torch.solve.lm import _trust_region_update, LMParams
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\n")
CLOSURE = (2, 11, np.array([0.4, -0.2]), 0.05, 3.0, 3.0)


@pytest.fixture(scope="module")
def jax_f64():
    """The JAX package's float64 runs (band, then dense with a closure over
    the cap), with x64 restored to the suite's default afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        cfg = load_config_text(CFG)
        js, _ = jax_make_problem(num_nodes=14, world_kind="building",
                                 num_beams=240, seed=3, dtype=jnp.float64,
                                 odom_noise_trans=0.02, odom_noise_rot=0.008)
        assert np.asarray(js.problem.points).dtype == np.float64
        arrays = {f: np.asarray(getattr(js.problem, f))
                  for f in js.problem._fields}
        stats = JSolver(js, cfg).solve_slam()
        band = (stats, js.solution.copy())
        js.lc_factors.append(CLOSURE)
        dsol = JSolver(js, load_config_text(CFG + "lr_factor_cap=0\n"))
        assert dsol._resolve_solver() == "dense"
        dstats = dsol.solve_max_window()
        return arrays, js.timestamps, band, (dstats, js.solution.copy())
    finally:
        jax.config.update("jax_enable_x64", False)


def test_resolve_dtype_names():
    assert resolve_solver_dtype("float32") == torch.float32
    assert resolve_solver_dtype("f64") == torch.float64
    assert resolve_solver_dtype("double") == torch.float64
    with pytest.raises(ValueError):
        resolve_solver_dtype("bfloat16")


def test_f64_solve_slam_matches_jax_x64(jax_f64):
    arrays, stamps, (jstats, jsol), (jd, jdsol) = jax_f64
    assert not jax.config.jax_enable_x64
    ts = SLAMState.from_problem(
        problem_from_numpy(arrays, "cpu", torch.float64), stamps)
    assert ts.problem.points.dtype == torch.float64
    assert ts.problem.planar_idx.dtype == torch.int64
    cfg = load_config_text(CFG)
    solver = TSolver(ts, cfg)
    assert solver._current_x().dtype == torch.float64
    tstats = solver.solve_slam()
    for jw, tw in zip(jstats.windows, tstats.windows):
        assert tw.initial_cost == pytest.approx(jw.initial_cost, rel=1e-9)
        assert tw.final_cost == pytest.approx(jw.final_cost, rel=1e-9)
        assert tw.iterations == jw.iterations
    np.testing.assert_allclose(ts.solution, jsol, atol=1e-8, rtol=0)
    # The gate's covariances come out in float64 too.
    m = LCMatcher.from_solver(solver)
    assert m._sys.diag.dtype == torch.float64
    # Past the closure cap: the dense route, in float64.
    ts.lc_factors.append(CLOSURE)
    dsolver = TSolver(ts, load_config_text(CFG + "lr_factor_cap=0\n"))
    tst = dsolver.solve_max_window()
    assert dsolver.last_solver == "dense"
    assert tst.final_cost == pytest.approx(jd.final_cost, rel=1e-9)
    np.testing.assert_allclose(ts.solution, jdsol, atol=1e-8, rtol=0)


def test_f64_and_f32_problems_share_preprocessing():
    """float64 is a cast of the float32 clouds, normals and features."""
    kw = dict(num_beams=180, seed=0, device="cpu")
    s32, _ = make_problem(6, "room", **kw)
    s64, _ = make_problem(6, "room", dtype=torch.float64, **kw)
    assert s64.problem.points.dtype == torch.float64
    assert s64.problem.odom_trans.dtype == torch.float64
    for name in ("points", "normals"):
        assert torch.equal(getattr(s64.problem, name),
                           getattr(s32.problem, name).double())
    assert torch.equal(s64.problem.planar_idx, s32.problem.planar_idx)
    assert torch.equal(s64.problem.edge_mask, s32.problem.edge_mask)


def test_csm_casts_a_float64_problems_clouds():
    kw = dict(num_beams=180, seed=0, device="cpu")
    s32, _ = make_problem(6, "room", **kw)
    s64, _ = make_problem(6, "room", dtype=torch.float64, **kw)
    params = CSMParams(scan_range=6.0, high_res=0.05)
    for engine in ("stage", "pair"):
        a = csm_match_pairs(s32.problem.points, s32.problem.points_mask,
                            [1, 3], [0, 2], params, engine=engine)
        b = csm_match_pairs(s64.problem.points, s64.problem.points_mask,
                            [1, 3], [0, 2], params, engine=engine)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_hitl_factors_take_the_problems_dtype():
    s64, _ = make_problem(6, "room", num_beams=180, seed=0, device="cpu",
                          dtype=torch.float64)
    cfg = load_config_text(CFG + "hitl_line_width=0.3\n"
                           "hitl_pose_point_threshold=5\n")
    solver = TSolver(s64, cfg)
    msg = thitl.HitlSlamInputMsg.from_points((-5, -5), (5, -5), (-5, 5),
                                             (5, 5))
    thitl.hitl_callback(solver, msg, verbose=False)
    rows = thitl.build_hitl_factors(s64)
    assert rows.points.dtype == torch.float64
    assert rows.seg_start.dtype == torch.float64
    assert solver._hitl_factors().points.dtype == torch.float64
    assert np.all(np.isfinite(s64.solution))
    assert np.isfinite(thitl.hitl_cost(s64))


def test_trust_region_floor_in_float64():
    """A step whose model and actual decrease are both 1e-100 has rho = 1
    against float64's floor of 1e-300 and is accepted; float32's floor of
    1e-30 swallows a decrease of 1e-35 (rho = 1e-5) and rejects it."""
    p = LMParams()
    for dtype, tiny, want in ((torch.float64, 1e-100, True),
                              (torch.float32, 1e-35, False)):
        t = lambda v: torch.tensor(v, dtype=dtype)
        accept, radius, _, _ = _trust_region_update(
            t(tiny), t(0.0), t(tiny), torch.tensor(True), t(1e4), t(2.0),
            t(0.0), p)
        assert bool(accept) is want
        assert radius.dtype == dtype
