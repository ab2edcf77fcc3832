"""PyTorch port: the block cyclic reduction (CR) backend of the band solver
against the JAX package's CR and against the port's scan."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve import band as jband
from nautilus_tpu.solve import factors as jfac
from nautilus_tpu.solve import hitl as jhitl
from nautilus_tpu.solve.lm import LMParams as JLMParams
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve import band as tband
from nautilus_tpu_torch.solve import factors as tfac
from nautilus_tpu_torch.solve import hitl as thitl
from nautilus_tpu_torch.solve.lm import LMParams, lm_solve_banded
from nautilus_tpu_torch.solve.solver import Solver

# CR against the scan, and the port against the JAX package, in float32:
# the JAX package's own CR-vs-scan tolerances (tests/test_band.py).  Steps
# are held relative to their largest entry, as chip_smoke.py holds the two
# backends on the card.
TRIDIAG_RTOL, TRIDIAG_ATOL = 2e-4, 2e-5
STEP_REL = 2e-3

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\nhitl_line_width=0.1\n"
       "hitl_pose_point_threshold=10\n")
LINES = ((2.0, -2.0), (10.0, -2.0), (2.0, -1.7), (10.0, -1.7))


def _spd_tridiag(K, S, m, seed):
    """A random SPD block tridiagonal (A, B) and a right-hand side r."""
    rng = np.random.RandomState(seed)
    A = np.zeros((K, S, S), np.float32)
    B = np.zeros((K, S, S), np.float32)
    for k in range(K):
        M = rng.randn(S, S)
        A[k] = M @ M.T + S * np.eye(S)
        if k:
            B[k] = 0.3 * rng.randn(S, S)
    return A, B, rng.randn(K, S, m).astype(np.float32)


@pytest.mark.parametrize("K", [1, 2, 5, 8])
def test_cr_tridiag_matches_jax(K):
    A, B, r = _spd_tridiag(K, 9, 3, seed=K)
    jx = np.asarray(jband.cr_solve_tridiag(
        jband.cr_factor_tridiag(jnp.asarray(A), jnp.asarray(B)),
        jnp.asarray(r)))
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    fac = tband.cr_factor_tridiag(At, Bt)
    assert bool(fac.ok)
    assert fac.K == 1 << (K - 1).bit_length()       # padded to a power of 2
    assert len(fac.levels) == (fac.K - 1).bit_length()
    x = tband.cr_solve_tridiag(fac, torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(x, jx, rtol=TRIDIAG_RTOL, atol=TRIDIAG_ATOL)
    Ls, Cs, ok = tband._tridiag_cholesky(At, Bt)
    x_scan = tband._tridiag_solve(Ls, Cs, torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(x, x_scan, rtol=TRIDIAG_RTOL,
                               atol=TRIDIAG_ATOL)


@pytest.mark.parametrize("method", ["auto", "scan", "cr"])
def test_resolve_band_plan_matches_jax(method):
    assert tband.CR_MIN_NODES == jband.CR_MIN_NODES == 2000
    for n in (2, 100, 1999, 2000, 5000, 50000):
        for w in (1, 3, 10, 12, 20):
            for superblock in (None, 4, 8, 16, 32):
                assert tband.resolve_band_plan(n, w, superblock, method) == \
                    jband.resolve_band_plan(n, w, superblock, method)


@pytest.fixture(scope="module")
def bordered():
    """A 24-pose office graph with a HITL constraint (the border) and two
    long-range loop closures (Woodbury U), assembled in both engines."""
    cfg = load_config_text(CFG)
    js, _ = make_problem(24, "office", num_beams=180, seed=0,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    # Poses 12-23 drift 0.3 m in y: the y = -2 wall shows twice.
    js.solution[12:, 1] += 0.3
    ts.solution = js.solution.copy()
    js.hitl_constraints.append(jhitl.select_poses(
        js, jhitl.HitlSlamInputMsg.from_points(*LINES), cfg))
    ts.hitl_constraints.append(thitl.select_poses(
        ts, thitl.HitlSlamInputMsg.from_points(*LINES), cfg))
    line_pose = np.array([[0.05, -0.03, 0.01]])
    js.line_poses = ts.line_poses = line_pose
    for (i, j) in [(2, 20), (5, 16)]:
        rel = js.solution[j] - js.solution[i]
        for s in (js, ts):
            s.lc_factors.append((i, j, rel[:2] + 0.02, float(rel[2]), 2.0,
                                 1.5))
    jsol, tsol = JSolver(js, cfg), Solver(ts, cfg)
    x = np.concatenate([js.solution, line_pose]).astype(np.float32)
    jgraph = jsol.build_graph(jnp.asarray(x), 3, exclude_long_range=True)
    tgraph = tsol.build_graph(torch.as_tensor(x), 3,
                              exclude_long_range=True)
    jsys, _ = jfac.assemble_banded_system(
        jnp.asarray(x), jgraph, jsol._layout, True, jsol._long_range_factors())
    tsys, _ = tfac.assemble_banded_system(
        torch.as_tensor(x), tgraph, tsol._layout, True,
        tsol._long_range_factors())
    assert tsys.num_lines == 1 and tsys.rank_lr == 6
    return tsol, x, tgraph, jsys, tsys


def _rel_err(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("superblock", [3, 4, 5])
def test_solve_damped_banded_cr_matches_jax(bordered, superblock):
    """K = 8, 6 and 5 superblocks: a power of two, and two padded ones."""
    tsol, _, _, jsys, tsys = bordered
    fixed = tsol._fixed_mask()
    params = LMParams()
    radius = torch.tensor(1e2)
    step, _, ok = tband.solve_damped_banded(tsys, fixed, radius, params,
                                            superblock, "cr")
    assert bool(ok) and step.shape == (25, 3)
    assert torch.all(step[0] == 0)
    jdx, jdxl, _ = jband.solve_damped_banded(
        jsys, jnp.asarray(fixed.numpy()), 1e2, JLMParams(), superblock, "cr")
    j_step = np.concatenate([np.asarray(jdx), np.asarray(jdxl)])
    assert _rel_err(step.numpy(), j_step) < STEP_REL
    scan, _, _ = tband.solve_damped_banded(tsys, fixed, radius, params,
                                           superblock, "scan")
    assert _rel_err(step.numpy(), scan.numpy()) < STEP_REL


def test_band_inverse_node_columns_cr_matches_jax(bordered):
    _, _, _, jsys, tsys = bordered
    fixed_np = np.repeat(np.arange(25) == 3, 3)
    cols = np.array([0, 4, 17, 30, 50, 71], np.int64)
    jX = np.asarray(jband.band_inverse_node_columns(
        jsys, jnp.asarray(fixed_np), jnp.asarray(cols, jnp.int32),
        superblock=4, method="cr"))
    tX = tband.band_inverse_node_columns(
        tsys, torch.as_tensor(fixed_np), torch.as_tensor(cols),
        superblock=4, method="cr").numpy()
    # The tolerance of the scan's test (test_torch_factors_band.py).
    np.testing.assert_allclose(tX, jX, rtol=2e-3,
                               atol=2e-3 * np.abs(jX).max())
    tX_scan = tband.band_inverse_node_columns(
        tsys, torch.as_tensor(fixed_np), torch.as_tensor(cols),
        superblock=4, method="scan").numpy()
    np.testing.assert_allclose(tX, tX_scan, rtol=2e-3,
                               atol=2e-3 * np.abs(tX_scan).max())


def test_lm_cr_matches_scan(bordered):
    """The band LM lands on the same map through either backend."""
    tsol, x, tgraph = bordered[:3]
    fixed = tsol._fixed_mask()
    lr = tsol._long_range_factors()
    runs = [lm_solve_banded(torch.as_tensor(x), tgraph, fixed,
                            layout=tsol._layout, lr=lr, superblock=4,
                            method=m) for m in ("scan", "cr")]
    np.testing.assert_allclose(runs[1].cost, runs[0].cost, rtol=1e-3)
    np.testing.assert_allclose(runs[1].x.numpy(), runs[0].x.numpy(),
                               rtol=5e-3, atol=5e-4)
    assert runs[1].cost < runs[1].initial_cost


def _synthetic_band(n, w, seed=7):
    """The JAX package's SPD test band: diag [n,3,3], band [w,n,3,3], g."""
    rng = np.random.RandomState(seed)
    diag = np.tile(8.0 * np.eye(3, dtype=np.float32), (n, 1, 1))
    sym = 0.1 * rng.randn(n, 3, 3).astype(np.float32)
    diag += 0.5 * (sym + sym.transpose(0, 2, 1))
    band = 0.2 * rng.randn(w, n, 3, 3).astype(np.float32)
    for d in range(1, w + 1):
        band[d - 1, :d] = 0.0
    return diag, band, rng.randn(n, 3).astype(np.float32)


def test_auto_is_cr_at_scale_in_both_packages(monkeypatch):
    n, w = tband.CR_MIN_NODES, 2
    diag, band, g = _synthetic_band(n, w)
    fixed = np.zeros(3 * n, bool)
    fixed[:3] = True
    tsys = tfac.BandedSystem(diag=torch.as_tensor(diag),
                             band=torch.as_tensor(band), g=torch.as_tensor(g))
    methods = []
    real_factor = tband.band_factor
    monkeypatch.setattr(tband, "band_factor", lambda sys, s, method="scan":
                        methods.append((s, method)) or real_factor(sys, s,
                                                                   method))
    step, _, ok = tband.solve_damped_banded(
        tsys, torch.as_tensor(fixed), torch.tensor(1e4), LMParams())
    assert methods == [(8, "cr")] and bool(ok)
    jsys = jband.BandedSystem(diag=jnp.asarray(diag), band=jnp.asarray(band),
                              g=jnp.asarray(g), C=None, E=None, gl=None)
    jdx, _, _ = jband.solve_damped_banded(jsys, jnp.asarray(fixed),
                                          jnp.asarray(1e4, jnp.float32),
                                          JLMParams())
    np.testing.assert_allclose(step.numpy(), np.asarray(jdx), rtol=2e-3,
                               atol=2e-4)
    scan, _, _ = tband.solve_damped_banded(
        tsys, torch.as_tensor(fixed), torch.tensor(1e4), LMParams(),
        superblock=16, method="scan")
    np.testing.assert_allclose(step.numpy(), scan.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_non_pd_system_is_not_ok_under_cr():
    """An indefinite damped system reports ok=False through CR, as through
    the scan: a failed Cholesky at a level or at the root."""
    for n in (5, 40):
        diag = -torch.eye(3).repeat(n, 1, 1)
        sys = tfac.BandedSystem(diag=diag, band=torch.zeros((1, n, 3, 3)),
                                g=torch.ones((n, 3)))
        fixed = torch.zeros(3 * n, dtype=torch.bool)
        params = LMParams(min_diagonal=-1e32)
        for method in ("cr", "scan"):
            _, _, ok = tband.solve_damped_banded(
                sys, fixed, torch.tensor(1e4), params, superblock=2,
                method=method)
            assert not bool(ok), (n, method)
        X = tband.band_inverse_node_columns(sys, fixed, torch.tensor([0, 1]),
                                            superblock=2, method="cr")
        assert torch.isnan(X).all()
    # Only the root fails: K = 1, no level.
    A = -torch.eye(6)[None]
    assert not bool(tband.cr_factor_tridiag(A, torch.zeros_like(A)).ok)
