"""PyTorch port: matrix-free PCG LM against the JAX package and against the
port's dense path (the bars of tests/test_cg.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve import cg as jcg
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve import band as tband
from nautilus_tpu_torch.solve import cg as tcg
from nautilus_tpu_torch.solve.factors import (assemble_banded_system,
                                              assemble_normal_equations)
from nautilus_tpu_torch.solve.lm import LMParams, fixed_pose_mask, lm_solve
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\n")


def _pair(n, kind, beams, seed, noise_rot=0.008, n_lr=0):
    js, _ = make_problem(num_nodes=n, world_kind=kind, num_beams=beams,
                         seed=seed, odom_noise_trans=0.02,
                         odom_noise_rot=noise_rot)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    # Long-range closures at solution-consistent relative poses.
    for k in range(n_lr):
        s, t = 2 + k, 30 + k
        rel = js.solution[t] - js.solution[s]
        f = (s, t, rel[:2].copy(), float(rel[2]), 2.0, 2.0)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    return js, ts


@pytest.fixture(scope="module")
def setup():
    cfg = load_config_text(CFG)
    js, ts = _pair(10, "room", 360, 4, noise_rot=0.01)
    jsol, tsol = JSolver(js, cfg), TSolver(ts, cfg)
    jx, tx = jsol._current_x(), tsol._current_x()
    return (jx, jsol.build_graph(jx, 3)), (tx, tsol.build_graph(tx, 3))


def test_linearize_and_hvp_match_dense_and_jax(setup, rng):
    (jx, jg), (tx, tg) = setup
    H, g, cost = assemble_normal_equations(tx, tg)
    terms, g2, diag, cost2 = tcg._linearize(tx, tg)
    torch.testing.assert_close(g2, g, rtol=1e-4, atol=1e-5)
    assert float(cost2) == pytest.approx(float(cost), rel=1e-5)
    v = rng.normal(size=g.shape).astype(np.float32)
    hv = tcg._hvp(terms, torch.as_tensor(v), v.shape[0])
    torch.testing.assert_close(hv, H @ torch.as_tensor(v), rtol=1e-3,
                               atol=1e-4)
    for p in range(tx.shape[0]):
        torch.testing.assert_close(diag[p], H[3 * p:3 * p + 3, 3 * p:3 * p + 3],
                                   rtol=1e-4, atol=1e-5)
    jterms, jg2, jdiag, jcost = jcg._linearize(jx, jg)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(diag.numpy(), np.asarray(jdiag), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(hv.numpy(),
                               np.asarray(jcg._hvp(jterms, jnp.asarray(v),
                                                   v.shape[0])),
                               rtol=1e-3, atol=1e-3)
    assert float(cost2) == pytest.approx(float(jcost), rel=1e-5)


def test_inv3x3_matches_jax_and_inverts(rng):
    a = rng.normal(size=(7, 3, 3)).astype(np.float32)
    blocks = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    inv = tcg._inv3x3(torch.as_tensor(blocks))
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(jcg._inv3x3(jnp.asarray(blocks))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(inv.numpy() @ blocks,
                               np.broadcast_to(np.eye(3), (7, 3, 3)),
                               atol=1e-4)


def test_cg_lm_matches_cholesky_lm_and_jax(setup):
    (jx, jg), (tx, tg) = setup
    fixed = fixed_pose_mask(3 * tx.shape[0])
    res_dense = lm_solve(tx, tg, fixed)
    res_cg = tcg.lm_solve_cg(tx, tg, fixed)
    assert res_cg.cost == pytest.approx(res_dense.cost, rel=2e-3)
    np.testing.assert_allclose(res_cg.x.numpy(), res_dense.x.numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(res_cg.x.numpy()[0], tx.numpy()[0],
                               atol=1e-7)                       # gauge
    jres = jcg.lm_solve_cg(jx, jg, jnp.asarray(fixed.numpy()))
    # CG stops on float32 dot products, so iteration counts and the last
    # digits differ between the packages: costs and poses, JAX's own bars.
    assert res_cg.cost == pytest.approx(float(jres.cost), rel=2e-3)
    np.testing.assert_allclose(res_cg.x.numpy(), np.asarray(jres.x),
                               atol=1e-2)


def test_cg_step_tolerance_ends_on_the_first_accepted_step(setup):
    _, (tx, tg) = setup
    fixed = fixed_pose_mask(3 * tx.shape[0])
    free = tcg.lm_solve_cg(tx, tg, fixed)
    stop = tcg.lm_solve_cg(tx, tg, fixed,
                           params=LMParams(step_tolerance=1e9))
    assert stop.iterations < free.iterations
    assert stop.converged and stop.cost < stop.initial_cost


def test_cg_without_forcing_reaches_the_same_cost(setup):
    _, (tx, tg) = setup
    fixed = fixed_pose_mask(3 * tx.shape[0])
    a = tcg.lm_solve_cg(tx, tg, fixed)
    b = tcg.lm_solve_cg(tx, tg, fixed,
                        cg_params=tcg.CGParams(ew_enabled=False))
    assert b.cost == pytest.approx(a.cost, rel=2e-3)


@pytest.fixture(scope="module")
def with_closures():
    cfg = load_config_text(CFG)
    js, ts = _pair(40, "building", 240, 4, n_lr=8)
    return JSolver(js, cfg, linear_solver="cg"), \
        TSolver(ts, cfg, linear_solver="cg")


def test_band_preconditioner_matches_jacobi_and_jax(with_closures):
    jsol, tsol = with_closures
    x, fixed = tsol._current_x(), tsol._fixed_mask()
    graph = tsol.build_graph(x, 3)
    bg = tsol.build_graph(x, 3, exclude_long_range=True)
    assert tsol._odom_within_band()
    assert graph.odom.count == bg.odom.count + 8
    res_j = tcg.lm_solve_cg(x, graph, fixed)
    res_b = tcg.lm_solve_cg(x, graph, fixed, band_graph=bg,
                            layout=tsol._layout)
    assert res_b.cost == pytest.approx(res_j.cost, rel=1e-3)
    np.testing.assert_allclose(res_b.x.numpy(), res_j.x.numpy(), rtol=1e-3,
                               atol=1e-3)
    jx = jsol._current_x()
    jres = jcg.lm_solve_cg(
        jx, jsol.build_graph(jx, 3), jsol._fixed_mask(),
        band_graph=jsol.build_graph(jx, 3, exclude_long_range=True),
        layout=jsol._layout)
    assert res_b.cost == pytest.approx(float(jres.cost), rel=1e-3)
    np.testing.assert_allclose(res_b.x.numpy(), np.asarray(jres.x),
                               rtol=1e-3, atol=1e-3)


def test_band_preconditioner_collapses_inner_iterations(with_closures):
    """One damped system, both preconditioners: the band's needs under 0.7
    of block Jacobi's iterations (the JAX test's bar)."""
    _, tsol = with_closures
    x, fixed = tsol._current_x(), tsol._fixed_mask()
    graph = tsol.build_graph(x, 3)
    bg = tsol.build_graph(x, 3, exclude_long_range=True)
    terms, g, diag, _ = tcg._linearize(x, graph)
    n_dof = 3 * x.shape[0]
    eye = 1e-4 * torch.eye(3)

    def matvec(v):
        return tcg._hvp(terms, v, n_dof) + 1e-4 * v

    inv = tcg._inv3x3(diag + eye)
    n = tsol._layout.n
    sysg = tband._apply_gauge_band(
        assemble_banded_system(x, bg, tsol._layout)[0], fixed)
    fac = tband.band_factor(sysg._replace(diag=sysg.diag + eye),
                            max(16, tsol._layout.w))
    assert bool(fac.ok)
    preconds = {
        "jacobi": lambda v: torch.einsum("mij,mj->mi", inv,
                                         v.reshape(-1, 3)).reshape(-1),
        "band": lambda v: torch.cat(
            [tband.band_apply_inverse(fac, v[:3 * n].reshape(n, 3))
             .reshape(-1), v[3 * n:]]),
    }
    b = -g.clone()
    b[:3] = 0.0
    iters = {}
    for name, precond in preconds.items():
        sol, iters[name] = tcg._cg(matvec, precond, b, 200, 1e-6)
        # CG stops on its recurrence residual; in float32, at 1e-4 damping,
        # the true residual stays ~1e-3 of |b| behind it.
        resid = torch.linalg.vector_norm(matvec(sol) - b)
        assert float(resid) <= 1e-2 * float(torch.linalg.vector_norm(b))
    assert iters["band"] < 0.7 * iters["jacobi"], iters


def test_cg_warm_start_from_the_solution_takes_no_iteration():
    A = torch.tensor([[4.0, 1.0], [1.0, 3.0]])
    b = torch.tensor([1.0, 2.0])
    x, k = tcg._cg(lambda v: A @ v, lambda v: v, b, 50, 1e-6)
    torch.testing.assert_close(A @ x, b, rtol=1e-5, atol=1e-6)
    assert 1 <= k <= 3
    _, k2 = tcg._cg(lambda v: A @ v, lambda v: v, b, 50, 1e-4, x0=x)
    assert k2 == 0
