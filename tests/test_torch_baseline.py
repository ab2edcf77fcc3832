"""PyTorch port: the float64 CPU referee (nautilus_tpu_torch/baseline/
cpu_reference.py) against the JAX package's referee on the same numpy
inputs, its analytic Jacobians against torch autograd, and the port's
float32 and float64 solves and HITL step within the 1 % final-cost bar of
the referee.

Both referees are the same numpy/scipy float64 program, so they are held
to each other at rtol 1e-12.  The port's engines against the referee: the
JAX package's bar, 1 % of the final cost under the referee's cost at each
solution's own final-window correspondences."""

import numpy as np
import pytest
import torch

from nautilus_tpu.baseline import cpu_reference as jcpu
from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem as jax_make_problem
from nautilus_tpu.ingest.synthetic import (
    reverse_traversal_problem as jax_reverse_traversal)
from nautilus_tpu_torch.baseline import cpu_reference as cpu
from nautilus_tpu_torch.cli import apply_hitl_line
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.ingest.synthetic import make_problem
from nautilus_tpu_torch.solve.factors import normal_residual, point_residual
from nautilus_tpu_torch.solve.solver import Solver

CFG = """
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
"""
# Two numpy float64 runs of the same program.
REFEREE_RTOL = 1e-12
# The JAX package's bar between an engine and the referee.
COST_PARITY_REL = 0.01
# chip_smoke.py's small HITL step: the reverse traversal's bottom wall at
# y = -6 and its copy 0.3 m up, which the return pass sees once its poses
# are shifted by 0.3 m (a doubled wall, which converges).
HITL_CFG = CFG + "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n"
LINE_A = ((-5.5, -6.0), (5.5, -6.0))
LINE_B = ((-5.5, -5.7), (5.5, -5.7))


def _arrays(jax_state):
    return {f: np.asarray(getattr(jax_state.problem, f))
            for f in jax_state.problem._fields}


def _port_state(arrays, dtype=torch.float32):
    return SLAMState.from_problem(problem_from_numpy(arrays, "cpu", dtype))


@pytest.fixture(scope="module")
def room():
    """The JAX package's cost-parity problem, and both referees' problems."""
    js, _ = jax_make_problem(num_nodes=10, world_kind="room", num_beams=360,
                             seed=11, odom_noise_trans=0.02,
                             odom_noise_rot=0.01)
    arrays = _arrays(js)
    ts = _port_state(arrays)
    return (arrays, jcpu.CpuProblem.from_device_problem(js.problem),
            cpu.CpuProblem.from_device_problem(ts.problem))


def _same_matches(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert (ca["s"], ca["t"]) == (cb["s"], cb["t"])
        for key in ("src_pts", "tgt_pts", "src_nrm", "tgt_nrm"):
            np.testing.assert_array_equal(ca[key], cb[key])


def test_cpu_problem_matches_jax_referee(room):
    _, jprob, prob = room
    for field in ("points", "normals", "planar_idx", "edge_idx"):
        ja, pa = getattr(jprob, field), getattr(prob, field)
        assert len(ja) == len(pa) == 10
        for x, y in zip(ja, pa):
            np.testing.assert_array_equal(y, x)
    for field in ("odom_i", "odom_j", "odom_trans", "odom_rot"):
        x, y = getattr(jprob, field), getattr(prob, field)
        assert y.dtype == x.dtype
        np.testing.assert_array_equal(y, x)
    # Floats in float64; the port's indices are int64 where JAX's are int32.
    assert prob.points[0].dtype == prob.normals[0].dtype == np.float64


def test_associate_system_and_cost_match_jax_referee(room):
    arrays, jprob, prob = room
    x = arrays["initial_poses"].astype(np.float64)
    planar, edge = cpu.associate(prob, x, 3, 0.25)
    jplanar, jedge = jcpu.associate(jprob, x, 3, 0.25)
    assert planar and edge
    _same_matches(planar, jplanar)
    _same_matches(edge, jedge)
    J, r = cpu.build_system(prob, x, planar, edge, 1.0, 1.0)
    jJ, jr = jcpu.build_system(jprob, x, jplanar, jedge, 1.0, 1.0)
    assert J.shape == jJ.shape
    np.testing.assert_allclose(J.toarray(), jJ.toarray(), rtol=REFEREE_RTOL,
                               atol=0)
    np.testing.assert_allclose(r, jr, rtol=REFEREE_RTOL, atol=0)
    assert cpu.total_cost(prob, x, planar, edge, 1.0, 1.0) == pytest.approx(
        jcpu.total_cost(jprob, x, jplanar, jedge, 1.0, 1.0),
        rel=REFEREE_RTOL)


def test_solve_slam_matches_jax_referee(room):
    arrays, jprob, prob = room
    cfg = load_config_text(CFG)
    x0 = arrays["initial_poses"].astype(np.float64)
    x, stats = cpu.solve_slam(prob, x0, cfg)
    jx, jstats = jcpu.solve_slam(jprob, x0, cfg)
    np.testing.assert_allclose(x, jx, rtol=REFEREE_RTOL, atol=1e-12)
    assert [w["window"] for w in stats.windows] == [1, 2, 3]
    for w, jw in zip(stats.windows, jstats.windows):
        assert w["cost"] == pytest.approx(jw["cost"], rel=REFEREE_RTOL)
        assert w["iterations"] == jw["iterations"]
    assert stats.final_cost == pytest.approx(jstats.final_cost,
                                             rel=REFEREE_RTOL)


def test_analytic_jacobians_match_autograd(rng):
    """The referee's hand-derived Jacobians == torch autograd of the port's
    residuals (the JAX package's test holds them to jax.jacfwd)."""
    xs, xt = rng.normal(size=3), rng.normal(size=3)
    pts, tgt = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
    ns, nt_ = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
    c = dict(s=0, t=1, src_pts=pts, tgt_pts=tgt, src_nrm=ns, tgt_nrm=nt_)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)[None]
    mask = torch.ones(1, 4, dtype=torch.bool)
    for kind in ("point", "normal"):
        r_cpu, Js_cpu, Jt_cpu = cpu._corr_residual_jac(np.stack([xs, xt]), c,
                                                      kind)
        if kind == "point":
            f = lambda a, b: point_residual(a[None], b[None], t(pts), t(tgt),
                                            mask).reshape(-1)
        else:
            # The port orders [r_tgt, r_src] per point, as the referee's
            # [r1 = target normal, r2 = source normal].
            f = lambda a, b: normal_residual(a[None], b[None], t(pts), t(tgt),
                                             t(ns), t(nt_), mask).reshape(-1)
        a, b = torch.as_tensor(xs), torch.as_tensor(xt)
        Js, Jt = torch.autograd.functional.jacobian(f, (a, b))
        np.testing.assert_allclose(r_cpu, f(a, b).numpy(), atol=1e-12)
        np.testing.assert_allclose(Js_cpu, Js.numpy(), atol=1e-12)
        np.testing.assert_allclose(Jt_cpu, Jt.numpy(), atol=1e-12)


def _f64_cost(prob, x, w=3, outlier=0.25):
    planar, edge = cpu.associate(prob, x, w, outlier)
    return cpu.total_cost(prob, x, planar, edge, 1.0, 1.0)


def test_engines_cost_parity(room):
    """The port's float32 CPU solve and the referee agree on final cost
    within 1 % under the referee's cost."""
    arrays, _, prob = room
    cfg = load_config_text(CFG)
    state = _port_state(arrays)
    x0 = state.solution.copy()
    Solver(state, cfg).solve_slam()
    x_cpu, _ = cpu.solve_slam(prob, x0, cfg)
    c_port, c_cpu = _f64_cost(prob, state.solution), _f64_cost(prob, x_cpu)
    assert abs(c_port - c_cpu) / c_cpu < COST_PARITY_REL, (c_port, c_cpu)


def test_f64_device_solve_parity():
    """The port's float64 solve against the referee (same arithmetic
    precision as Ceres), within the 1 % bar."""
    state, _ = make_problem(num_nodes=14, world_kind="building",
                            num_beams=240, seed=3, dtype=torch.float64,
                            odom_noise_trans=0.02, odom_noise_rot=0.008,
                            device="cpu")
    assert state.problem.points.dtype == torch.float64
    cfg = load_config_text(CFG)
    x0 = state.solution.copy()
    Solver(state, cfg).solve_slam()
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    x_cpu, _ = cpu.solve_slam(prob, x0, cfg)
    c_dev, c_cpu = _f64_cost(prob, state.solution), _f64_cost(prob, x_cpu)
    assert abs(c_dev - c_cpu) / c_cpu < COST_PARITY_REL, (c_dev, c_cpu)


def test_cpu_solver_reduces_cost():
    state, _ = make_problem(num_nodes=8, world_kind="room", num_beams=360,
                            seed=2, odom_noise_trans=0.03,
                            odom_noise_rot=0.01, device="cpu")
    cfg = load_config_text(CFG)
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    x0 = state.solution.copy()
    c0 = _f64_cost(prob, x0, w=2)
    x, stats = cpu.solve_slam(prob, x0, cfg)
    assert stats.final_cost < c0 or _f64_cost(prob, x) < c0


@pytest.fixture(scope="module")
def doubled_wall():
    """The reverse traversal with its return pass shifted 0.3 m (a doubled
    wall), as arrays for both packages, and the shifted solution."""
    js, _ = jax_reverse_traversal(3)
    x = js.solution.copy()
    x[19:, 1] += 0.3
    return _arrays(js), x


def test_hitl_matches_jax_referee(doubled_wall):
    arrays, x = doubled_wall
    cfg = load_config_text(HITL_CFG)
    ts = _port_state(arrays)
    prob = cpu.CpuProblem.from_device_problem(ts.problem)
    jprob = jcpu.CpuProblem.from_device_problem(ts.problem)
    a_rows, b_rows = cpu.select_hitl(prob, x, LINE_A, LINE_B, 0.1, 10)
    ja_rows, jb_rows = jcpu.select_hitl(jprob, x, LINE_A, LINE_B, 0.1, 10)
    assert a_rows and b_rows
    for rows, jrows in ((a_rows, ja_rows), (b_rows, jb_rows)):
        assert [k for k, _ in rows] == [k for k, _ in jrows]
        for (_, p), (_, jp) in zip(rows, jrows):
            np.testing.assert_array_equal(p, jp)
    x_h, stats = cpu.hitl_callback(prob, x.copy(), cfg, LINE_A, LINE_B)
    jx_h, jstats = jcpu.hitl_callback(jprob, x.copy(), cfg, LINE_A, LINE_B)
    np.testing.assert_allclose(x_h, jx_h, rtol=REFEREE_RTOL, atol=1e-12)
    assert stats.final_cost == pytest.approx(jstats.final_cost,
                                             rel=REFEREE_RTOL)
    assert stats.line_poses.shape == (1, 3)
    # The ingest-time odometry is back after the step.
    np.testing.assert_array_equal(prob.odom_i, jprob.odom_i)
    np.testing.assert_array_equal(prob.odom_trans, arrays["odom_trans"])


def test_hitl_step_cost_parity(doubled_wall):
    """The port's HITL step (two solves on the CPU) within 1 % of the
    referee's hitl_callback under the referee's cost with the same rows,
    as chip_smoke.py phase 17 holds the card's."""
    arrays, x = doubled_wall
    cfg = load_config_text(HITL_CFG)
    state = _port_state(arrays)
    state.solution = x.copy()
    prob = cpu.CpuProblem.from_device_problem(state.problem)
    apply_hitl_line(Solver(state, cfg), [str(v) for ab in LINE_A + LINE_B
                                         for v in ab], verbose=False)
    x_cpu, stats = cpu.hitl_callback(prob, x.copy(), cfg, LINE_A, LINE_B)
    rows = cpu.hitl_rows(prob, x, cfg, LINE_A, LINE_B)
    c = state.hitl_constraints[0]
    assert sorted(k for k, _ in c.line_a_poses + c.line_b_poses) == \
        sorted(rows.node.tolist())

    def cost(xn, line_poses):
        planar, edge = cpu.associate(prob, xn, 3, 0.25)
        return cpu.total_cost(prob, np.concatenate([xn, line_poses]),
                              planar, edge, 1.0, 1.0, hitl=rows)

    c_port = cost(state.solution, state.line_poses)
    c_cpu = cost(x_cpu, stats.line_poses)
    c_start = cost(x, np.zeros((1, 3)))
    assert c_cpu < c_start
    assert abs(c_port - c_cpu) / c_cpu < COST_PARITY_REL, (c_port, c_cpu)
