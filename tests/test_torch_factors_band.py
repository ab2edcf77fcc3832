"""PyTorch port: band assembly and the block-band solver against the JAX
package and against dense float64 linear algebra."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve import band as jband
from nautilus_tpu.solve import factors as jfac
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve import band as tband
from nautilus_tpu_torch.solve import factors as tfac
from nautilus_tpu_torch.solve.lm import LMParams
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\n")
N = 18


@pytest.fixture(scope="module")
def setup():
    """The same graph in both engines, with one in-band and two long-range
    loop-closure factors applied."""
    cfg = load_config_text(CFG)
    js, _ = make_problem(N, "office", num_beams=180, seed=2,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    rng = np.random.default_rng(0)
    for (i, j) in [(4, 6), (1, 15), (3, 12)]:
        rel = js.solution[j] - js.solution[i] + rng.normal(scale=0.05, size=3)
        f = (i, j, rel[:2].copy(), float(rel[2]), 2.0, 1.5)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    jsol, tsol = JSolver(js, cfg), TSolver(ts, cfg)
    x = js.solution.astype(np.float32)
    jgraph = jsol.build_graph(jnp.asarray(x), 3, exclude_long_range=True)
    tgraph = tsol.build_graph(torch.as_tensor(x), 3,
                              exclude_long_range=True)
    return jsol, tsol, x, jgraph, tgraph


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max()


@pytest.mark.parametrize("analytic", ["moments", True])
def test_assemble_banded_matches_jax(setup, analytic):
    jsol, tsol, x, jgraph, tgraph = setup
    jsys, jcost = jfac.assemble_banded_system(
        jnp.asarray(x), jgraph, jsol._layout, analytic,
        jsol._long_range_factors())
    tsys, tcost = tfac.assemble_banded_system(
        torch.as_tensor(x), tgraph, tsol._layout, analytic,
        tsol._long_range_factors())
    # Float32 summation order differs: tolerance relative to max |H|.
    scale = float(np.abs(np.asarray(jsys.diag)).max())
    assert _rel(tsys.diag, jsys.diag) <= 1e-4 * scale
    assert _rel(tsys.band, jsys.band) <= 1e-4 * scale
    assert _rel(tsys.g, jsys.g) <= 1e-4 * max(
        float(np.abs(np.asarray(jsys.g)).max()), 1.0)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-4)
    # JAX pads the Woodbury columns to a bucket of 4 closures (zeros).
    ju = np.asarray(jsys.U)[:, :tsys.U.shape[1]]
    np.testing.assert_allclose(tsys.U.numpy(), ju, rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(jsys.U)[:, tsys.U.shape[1]:] == 0)


def test_band_to_dense_symmetric(setup):
    _, tsol, x, _, tgraph = setup
    sys, _ = tfac.assemble_banded_system(torch.as_tensor(x), tgraph,
                                         tsol._layout)
    H = tfac._band_to_dense(sys.diag, sys.band, tsol._layout)
    jH = jfac._band_to_dense(jnp.asarray(sys.diag.numpy()),
                             [jnp.asarray(b) for b in sys.band.numpy()],
                             jfac.BandLayout(*tsol._layout))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jH))


def _dense_reference(sys, fixed, radius, params):
    """Damped gauged system solved densely in float64."""
    n = sys.n
    layout = tfac.BandLayout(n, sys.w)
    H = tfac._band_to_dense(sys.diag.double(), sys.band.double(), layout)
    if sys.U is not None:
        H = H + sys.U.double() @ sys.U.double().T
    g = sys.g.double().reshape(-1)
    free = ~fixed
    Hg = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
    Hg = Hg + torch.diag(fixed.double())
    g = torch.where(free, g, torch.zeros_like(g))
    d = torch.clamp(torch.diagonal(Hg), params.min_diagonal,
                    params.max_diagonal)
    d = torch.where(fixed, torch.zeros_like(d), d)
    return torch.linalg.solve(Hg + torch.diag(d / radius), -g).reshape(n, 3)


@pytest.mark.parametrize("with_lr", [False, True])
def test_solve_damped_banded_matches_dense_f64(setup, with_lr):
    _, tsol, x, _, tgraph = setup
    lr = tsol._long_range_factors() if with_lr else None
    sys, _ = tfac.assemble_banded_system(torch.as_tensor(x), tgraph,
                                         tsol._layout, lr=lr)
    assert (sys.U is not None) == with_lr
    fixed = tsol._fixed_mask()
    params = LMParams()
    radius = torch.tensor(1e2)
    dx, _, ok = tband.solve_damped_banded(sys, fixed, radius, params)
    ref = _dense_reference(sys, fixed, 1e2, params)
    assert bool(ok)
    # Float32 band Cholesky against float64 dense: relative to max |dx|.
    err = (dx.double() - ref).abs().max() / ref.abs().max()
    assert float(err) < 1e-4
    assert torch.all(dx[0] == 0)


def test_band_inverse_node_columns_matches_jax(setup):
    jsol, tsol, x, jgraph, tgraph = setup
    jsys, _ = jfac.assemble_banded_system(
        jnp.asarray(x), jgraph, jsol._layout, True,
        jsol._long_range_factors())
    tsys, _ = tfac.assemble_banded_system(
        torch.as_tensor(x), tgraph, tsol._layout, True,
        tsol._long_range_factors())
    fixed_np = np.repeat(np.arange(N) == 3, 3)
    cols = np.array([0, 4, 17, 30, 50], np.int64)
    jX = np.asarray(jband.band_inverse_node_columns(
        jsys, jnp.asarray(fixed_np), jnp.asarray(cols, jnp.int32)))
    tX = tband.band_inverse_node_columns(
        tsys, torch.as_tensor(fixed_np), torch.as_tensor(cols)).numpy()
    np.testing.assert_allclose(tX, jX, rtol=2e-3,
                               atol=2e-3 * np.abs(jX).max())


def test_failed_cholesky_is_a_rejected_step():
    """An indefinite damped system reports ok=False instead of raising."""
    n = 5
    diag = -torch.eye(3).repeat(n, 1, 1)
    sys = tfac.BandedSystem(diag=diag, band=torch.zeros((1, n, 3, 3)),
                            g=torch.ones((n, 3)))
    fixed = torch.zeros(3 * n, dtype=torch.bool)
    params = LMParams(min_diagonal=-1e32)
    _, _, ok = tband.solve_damped_banded(sys, fixed, torch.tensor(1e4),
                                         params)
    assert not bool(ok)
    X = tband.band_inverse_node_columns(sys, fixed, torch.tensor([0, 1]))
    assert torch.isnan(X).all()


def test_total_cost_matches_jax_and_assembly(setup):
    jsol, tsol, x, jgraph, tgraph = setup
    jc = float(jfac.total_cost(jnp.asarray(x), jgraph))
    tc = float(tfac.total_cost(torch.as_tensor(x), tgraph))
    _, asm_cost = tfac.assemble_banded_system(torch.as_tensor(x), tgraph,
                                              tsol._layout)
    # Float32 sums in another order.
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(float(asm_cost), tc, rtol=1e-5)
