"""PyTorch port: the factor-parallel solve and the CSM batch
(parallel/sharded.py) on a mesh of 2 processes against the JAX package's on
a mesh of 2 virtual CPU devices, and against the port's single-process
run.  Costs and poses are held, never iteration counts: a sum over ranks
adds in another order than one process does, and LM's stop tests read
float32 noise once converged."""

import dataclasses
import shutil
import time
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.kernels.csm import CSMParams as JParams
from nautilus_tpu.parallel import sharded as jshard
from nautilus_tpu.solve import factors as jfac
from nautilus_tpu.solve import hitl as jhitl
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
from nautilus_tpu_torch.io.poses import read_pose_file
from nautilus_tpu_torch.kernels.csm import CSMParams, csm_match_pairs
from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
from nautilus_tpu_torch.parallel import sharded as tshard
from nautilus_tpu_torch.parallel.worker import TIMEOUT_S
from nautilus_tpu_torch.solve import factors as tfac
from nautilus_tpu_torch.solve import hitl as thitl
from nautilus_tpu_torch.solve.lm import lm_solve
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n"
       "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n")
# tests/test_torch_hitl.py's doubled wall: on the solved 24-pose office map
# poses 12-23 are shifted 0.3 m in y, line A is drawn on the wall, line B on
# its copy, so the constraint converges.
SHIFT = 0.3
LINES = ((2.0, -2.0), (10.0, -2.0), (2.0, -2.0 + SHIFT), (10.0, -2.0 + SHIFT))
COST_RTOL, POSE_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def mesh():
    with tshard.Mesh(2, "cpu") as m:
        yield m


@pytest.fixture(scope="module")
def jmesh():
    return jshard.default_mesh(2)


def _states(n=24, closures=(), hitl=False):
    """The JAX and the port's state of the office map on the same arrays,
    with long-range closures between ``closures`` pairs, and with the
    doubled wall and its HITL constraint if ``hitl``."""
    cfg = load_config_text(CFG)
    js, _ = make_problem(n, "office", num_beams=180, seed=0,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    rng = np.random.default_rng(1)
    for i, j in closures:
        rel = js.solution[j] - js.solution[i] + rng.normal(0, 0.02, 3)
        f = (i, j, rel[:2].copy(), float(rel[2]), 2.0, 1.5)
        js.lc_factors.append(f)
        ts.lc_factors.append(f)
    if hitl:
        # From the solved map, as the curation step starts: from the
        # unsolved one LM ends 2e-2 apart already between the two packages'
        # single-process sweeps.
        TSolver(ts, cfg).solve_slam()
        js.solution = ts.solution.copy()
        for s in (js, ts):
            s.solution[12:, 1] += SHIFT
        js.hitl_constraints.append(jhitl.select_poses(
            js, jhitl.HitlSlamInputMsg.from_points(*LINES), cfg))
        ts.hitl_constraints.append(thitl.select_poses(
            ts, thitl.HitlSlamInputMsg.from_points(*LINES), cfg))
        js.line_poses = np.zeros((1, 3))
        ts.line_poses = np.zeros((1, 3))
    return cfg, js, ts


def _fresh(ts):
    return dataclasses.replace(ts, solution=ts.solution.copy(),
                               line_poses=ts.line_poses.copy(),
                               lc_factors=list(ts.lc_factors),
                               hitl_constraints=list(ts.hitl_constraints))


def _graphs(n=24):
    cfg, js, ts = _states(n)
    jsol, tsol = JSolver(js, cfg), TSolver(ts, cfg)
    x = js.solution.astype(np.float32)
    return (jsol, jsol.build_graph(jnp.asarray(x), 3, exclude_long_range=True),
            tsol, tsol.build_graph(torch.as_tensor(x), 3,
                                   exclude_long_range=True), x)


def _take(batch, rows, jax_side):
    if jax_side:
        return type(batch)(*[jnp.asarray(np.asarray(a)[rows]) for a in batch])
    return batch._replace(**{f: v[torch.as_tensor(rows)]
                             for f, v in batch._asdict().items()
                             if torch.is_tensor(v)})


def _pair_span(graph) -> int:
    """The largest |src - tgt| of a graph's correspondences, on the host."""
    return max((int(np.abs(c.src.numpy() - c.tgt.numpy()).max())
                for c in (graph.planar, graph.edge) if c.src.shape[0]),
               default=0)


def _close_band(a, b, rel):
    """Two (BandedSystem, cost) within ``rel`` of their largest entry."""
    (sa, ca), (sb, cb) = a, b
    for name in ("diag", "band", "g"):
        va, vb = np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name))
        np.testing.assert_allclose(va, vb, rtol=0,
                                   atol=rel * max(np.abs(vb).max(), 1.0))
    np.testing.assert_allclose(float(ca), float(cb), rtol=rel)


@pytest.mark.parametrize("analytic", ["moments", True])
def test_assemble_banded_scatter_matches_jax(analytic):
    """A shuffled slice of every factor list scatters as JAX's does; the
    scatters of two slices sum to the whole graph's band assembly."""
    jsol, jg, tsol, tg, x = _graphs()
    rng = np.random.default_rng(3)
    picks = {k: rng.permutation(getattr(tg, k)[0].shape[0])[:100]
             for k in ("odom", "planar", "edge")}
    jsub = jg._replace(**{k: _take(getattr(jg, k), p, True)
                          for k, p in picks.items()})
    tsub = tg._replace(**{k: _take(getattr(tg, k), p, False)
                          for k, p in picks.items()})
    n, w = tsol._layout.n, tsol._layout.w
    got = tfac.assemble_banded_scatter(torch.as_tensor(x), tsub, n, w,
                                       analytic, pair_span=_pair_span(tsub))
    want = jfac.assemble_banded_scatter(jnp.asarray(x), jsub, n, w, analytic)
    _close_band(got, want, 1e-5)
    assert got[0].U is None and got[0].C is None
    halves = []
    for lo, hi in ((0, 0.5), (0.5, 1.0)):
        part = {k: np.arange(int(lo * c), int(hi * c)) for k, c in
                ((k, getattr(tg, k)[0].shape[0]) for k in picks)}
        half = tg._replace(**{k: _take(getattr(tg, k), p, False)
                              for k, p in part.items()})
        halves.append(tfac.assemble_banded_scatter(
            torch.as_tensor(x), half, n, w, analytic,
            pair_span=_pair_span(half)))
    summed = (halves[0][0]._replace(
        diag=halves[0][0].diag + halves[1][0].diag,
        band=halves[0][0].band + halves[1][0].band,
        g=halves[0][0].g + halves[1][0].g), halves[0][1] + halves[1][1])
    whole = tfac.assemble_banded_system(torch.as_tensor(x), tg, tsol._layout,
                                        analytic)
    _close_band(summed, whole, 1e-5)


def test_band_scatter_refuses_an_out_of_band_pair_on_the_host():
    _, _, tsol, tg, x = _graphs(12)
    assert _pair_span(tg) == 3
    with pytest.raises(ValueError, match=r"\|i - j\| = 3 > 2"):
        tfac.assemble_banded_scatter(torch.as_tensor(x), tg, 12, 2,
                                     pair_span=_pair_span(tg))
    with pytest.raises(ValueError, match=r"\|i - j\| = 5 > 3"):
        tfac.assemble_banded_scatter(torch.as_tensor(x), tg, 12, 3,
                                     pair_span=5)


def test_sharded_lm_solve_matches_jax(mesh, jmesh):
    jsol, jg, tsol, tg, x = _graphs()
    fixed = tsol._fixed_mask()
    jres = jshard.sharded_lm_solve(jnp.asarray(x), jg, jsol._fixed_mask(),
                                   jmesh)
    tres = tshard.sharded_lm_solve(torch.as_tensor(x), tg, fixed, mesh)
    one = lm_solve(torch.as_tensor(x), tg, fixed)
    for ref_cost, ref_x in ((float(jres.cost), np.asarray(jres.x)),
                            (one.cost, one.x.numpy())):
        np.testing.assert_allclose(tres.cost, ref_cost, rtol=COST_RTOL)
        np.testing.assert_allclose(tres.x.numpy(), ref_x, atol=POSE_ATOL,
                                   rtol=0)


# (solver kind, assembly form, long-range closures, HITL)
SWEEPS = {
    "dense": ("dense", True, (), False),
    "band-jacobian": ("band", True, (), False),
    "band-moments": ("band", "moments", (), False),
    "band-lr": ("band", True, ((1, 20), (3, 22)), False),
    "dense-hitl": ("dense", True, (), True),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sharded_sweep_matches_jax_and_one_process(mesh, jmesh, case):
    kind, analytic, closures, hitl = SWEEPS[case]
    cfg, js, ts = _states(closures=closures, hitl=hitl)
    use_band = kind == "band"
    jsol = JSolver(js, cfg)
    jx = jsol._current_x()
    jout = jshard.sharded_sweep(
        jx, js.problem, jsol._pair_src, jsol._pair_tgt,
        jsol._odom_factors(exclude_long_range=use_band), jsol._hitl_factors(),
        jsol._fixed_mask(), jnp.asarray(0.25, jx.dtype), 1, 3, jmesh,
        jsol.lm_params, use_band=use_band,
        lr=jsol._long_range_factors() if use_band else None,
        analytic=analytic)
    one = _fresh(ts)
    stats = TSolver(one, cfg, linear_solver=kind,
                    assembly="jacobian" if analytic is True else "moments"
                    ).solve_slam()
    tsol = TSolver(ts, cfg)
    x, initial, final, iterations = tshard.sharded_sweep(
        tsol._current_x(), ts.problem, tsol._pair_src, tsol._pair_tgt,
        tsol._odom_factors(exclude_long_range=use_band),
        tsol._hitl_factors(), tsol._fixed_mask(), 0.25, 1, 3, mesh,
        tsol.lm_params, use_band=use_band,
        lr=tsol._long_range_factors() if use_band else None,
        analytic=analytic)
    n, L = ts.num_nodes, ts.line_poses.shape[0]
    assert x.shape == (n + L, 3) and iterations.shape == (3,)
    assert np.all(iterations < 50)
    assert np.all(final <= initial + 1e-6)
    np.testing.assert_allclose(final, np.asarray(jout[2]), rtol=COST_RTOL)
    np.testing.assert_allclose(final, [w.final_cost for w in stats.windows],
                               rtol=COST_RTOL)
    for ref in (np.asarray(jout[0])[:n + L],
                np.concatenate([one.solution, one.line_poses])):
        np.testing.assert_allclose(x.numpy(), ref, atol=POSE_ATOL, rtol=0)


def test_sweep_refusals_raise_before_any_command():
    """Each refusal raises ValueError on a closed mesh, which refuses every
    command: no collective started."""
    cfg, js, ts = _states(n=12, closures=((1, 10),))
    closed = tshard.Mesh(1, "cpu")
    closed.close()
    tsol = TSolver(ts, cfg)
    args = (tsol._current_x(), ts.problem, tsol._pair_src, tsol._pair_tgt)
    rest = (tsol._hitl_factors(), tsol._fixed_mask(), 0.25, 1, 3, closed)
    with pytest.raises(ValueError, match="odometry factors"):
        tshard.sharded_sweep(*args, tsol._odom_factors(), *rest,
                             use_band=True)
    far = (torch.cat([args[2], torch.tensor([9])]),
           torch.cat([args[3], torch.tensor([0])]))
    with pytest.raises(ValueError, match="correspondence pairs"):
        tshard.sharded_sweep(*args[:2], *far,
                             tsol._odom_factors(exclude_long_range=True),
                             *rest, use_band=True)
    with pytest.raises(ValueError, match="lr factors"):
        tshard.sharded_sweep(*args, tsol._odom_factors(), *rest,
                             lr=tsol._long_range_factors())
    with pytest.raises(RuntimeError, match="closed"):
        tshard.sharded_sweep(*args, tsol._odom_factors(), *rest)


@pytest.fixture(scope="module")
def pairs():
    """tests/test_torch_csm.py's pairs, and 3 more so the slices differ."""
    state, _ = make_problem(16, "office", num_beams=360, seed=0)
    pts = np.asarray(state.problem.points)
    msk = np.asarray(state.problem.points_mask)
    ss = np.array([0, 3, 5, 10, 12, 2, 7, 8, 14])
    tt = np.array([1, 5, 9, 11, 14, 15, 6, 9, 13])
    d = state.solution[ss, 2] - state.solution[tt, 2]
    return pts, msk, ss, tt, np.arctan2(np.sin(d), np.cos(d))


def test_csm_match_pairs_sharded(mesh, jmesh, pairs):
    pts, msk, ss, tt, centers = pairs
    kw = dict(scan_range=10.0, high_res=0.05)
    tp, tm = torch.tensor(pts), torch.tensor(msk)
    s, tr = tshard.csm_match_pairs_sharded(tp, tm, ss, tt, mesh,
                                           CSMParams(**kw), centers)
    s1, tr1 = csm_match_pairs(tp, tm, ss, tt, CSMParams(**kw),
                              rotation_centers=centers, engine="pair")
    assert s.dtype == tr.dtype == np.float32 and tr.shape == (9, 3)
    np.testing.assert_array_equal(s, s1)
    np.testing.assert_array_equal(tr, tr1)
    js, jtr = jshard.csm_match_pairs_sharded(pts, msk, ss, tt, jmesh,
                                             JParams(**kw), centers)
    # tests/test_torch_csm.py's tolerances: scores, and the finest grid
    # step in translation and rotation.
    np.testing.assert_allclose(s, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr[:, :2], jtr[:, :2], atol=0.05 + 1e-6,
                               rtol=0)
    np.testing.assert_allclose(tr[:, 2], jtr[:, 2], atol=0.005 + 1e-6,
                               rtol=0)
    empty = tshard.csm_match_pairs_sharded(tp, tm, [], [], mesh)
    assert empty[0].shape == (0,) and empty[1].shape == (0, 3)
    assert mesh.launches() == [{"fused_coarse": 0, "correlate": 0}] * 2


@pytest.mark.parametrize("size", [1, 3])
def test_other_world_sizes_give_the_same_sweep(mesh, size):
    """A world of 1 runs the same code with nothing spawned; 3 ranks split
    the pair list and the two closures unevenly (one rank holds none)."""
    cfg, _, ts = _states(closures=((1, 20), (3, 22)))

    def sweep(m):
        tsol = TSolver(ts, cfg)
        return tshard.sharded_sweep(
            tsol._current_x(), ts.problem, tsol._pair_src, tsol._pair_tgt,
            tsol._odom_factors(exclude_long_range=True), None,
            tsol._fixed_mask(), 0.25, 1, 3, m, tsol.lm_params, use_band=True,
            lr=tsol._long_range_factors())

    x2, _, f2, _ = sweep(mesh)
    with tshard.Mesh(size, "cpu") as other:
        assert len(other._procs) == size - 1
        xs, _, fs, _ = sweep(other)
    np.testing.assert_allclose(fs, f2, rtol=COST_RTOL)
    np.testing.assert_allclose(xs.numpy(), x2.numpy(), atol=POSE_ATOL, rtol=0)


def test_a_killed_worker_raises_in_the_controller():
    """A worker killed in the middle of a solve: the controller's next
    collective raises within the mesh's timeout, the mesh closes and no
    process is left."""
    cfg, _, ts = _states(n=12)
    tsol = TSolver(ts, cfg)
    m = tshard.Mesh(2, "cpu")
    serve, seen = m.rank.serve, []

    def serve_then_kill(cmd, payload):
        seen.append(cmd)
        if seen.count("assemble") == 3:
            m._procs[0].kill()
        return serve(cmd, payload)

    m.rank.serve = serve_then_kill
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1"):
        tshard.sharded_sweep(
            tsol._current_x(), ts.problem, tsol._pair_src, tsol._pair_tgt,
            tsol._odom_factors(), None, tsol._fixed_mask(), 0.25, 1, 3, m,
            tsol.lm_params)
    assert time.perf_counter() - t0 < TIMEOUT_S
    assert m.closed and not m._procs[0].is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        m.launches()


@pytest.mark.parametrize("kind,ran", [("auto", "band"), ("cg", "dense")])
def test_solver_on_a_mesh_matches_one_process(mesh, kind, ran):
    """solve_slam, then solve_max_window, with two long-range closures: on
    the band (the closures as Woodbury columns) or, for 'cg', which has no
    sharded engine, dense; against one process on the same route."""
    cfg, _, ts = _states(closures=((1, 20), (3, 22)))
    one = _fresh(ts)
    single = TSolver(one, cfg, linear_solver=ran)
    want = [single.solve_slam(), single.solve_max_window()]
    sharded = TSolver(ts, cfg, linear_solver=kind, mesh=mesh)
    got = [sharded.solve_slam(), sharded.solve_max_window()]
    assert sharded.last_solver == single.last_solver == ran
    for g, w in zip(got, want):
        assert [s.window for s in g.windows] == [s.window for s in w.windows]
        np.testing.assert_allclose([s.final_cost for s in g.windows],
                                   [s.final_cost for s in w.windows],
                                   rtol=COST_RTOL)
    np.testing.assert_allclose(ts.solution, one.solution, atol=POSE_ATOL,
                               rtol=0)


def test_type_all_on_a_mesh_warns_and_runs_on_one_process(mesh):
    cfg, _, ts = _states(n=8)
    one = _fresh(ts)
    want = TSolver(one, cfg).solve_slam("all")
    with pytest.warns(UserWarning, match="single-device"):
        got = TSolver(ts, cfg, mesh=mesh).solve_slam("all")
    np.testing.assert_allclose(got.final_cost, want.final_cost,
                               rtol=COST_RTOL)
    np.testing.assert_allclose(ts.solution, one.solution, atol=POSE_ATOL,
                               rtol=0)


# tests/test_torch_auto_lc.py's reverse traversal.
AUTO_LC = """
translation_weight=1
rotation_weight=1
lc_translation_weight=3
lc_rotation_weight=3
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
max_lidar_range=10
csm_score_threshold=-3.5
keyframe_local_uncertainty_filtering=true
lc_match_window_size=2
accuracy_change_stop_threshold=0.0001
"""


def test_auto_lc_on_a_mesh_matches_one_process(mesh):
    """With a mesh auto-LC matches the gated pairs on the sharded pair
    engine and re-solves over the mesh: the same closures are accepted."""
    cfg = load_config_text(AUTO_LC)
    ts, _ = reverse_traversal_problem(3, device="cpu")
    TSolver(ts, cfg).solve_slam()
    one = _fresh(ts)
    params = CSMParams(scan_range=10.0, high_res=0.05)
    want = solve_auto_lc(TSolver(one, cfg), apply=True, verbose=False,
                         csm_params=params)
    got = solve_auto_lc(TSolver(ts, cfg, mesh=mesh), apply=True,
                        verbose=False, csm_params=params)
    assert (want.csm_engine, got.csm_engine) == ("stage", "sharded pair")
    assert got.gated_pairs == want.gated_pairs
    assert got.accepted == want.accepted and got.accepted
    np.testing.assert_allclose(ts.solution, one.solution, atol=POSE_ATOL,
                               rtol=0)


CLI_CFG = """
dofile("default_config.lua")
pose_number=10
lidar_constraint_amount_max=4
pose_output_file="{poses}"
"""


def test_cli_devices_2_gives_the_single_device_poses(tmp_path):
    """tests/test_cli.py's --devices case: the sharded CLI run writes the
    single-device poses."""
    shutil.copy(Path(__file__).resolve().parents[1] / "config"
                / "default_config.lua", tmp_path / "default_config.lua")
    poses = []
    for name, extra in (("one", []), ("mesh", ["--devices", "2"])):
        cfg = tmp_path / f"{name}.lua"
        cfg.write_text(CLI_CFG.format(poses=tmp_path / f"{name}.txt"))
        assert torch_cli.main(["--config_file", str(cfg), "--synthetic",
                               "room", "--write", "--quiet", "--device",
                               "cpu", *extra]) == 0
        poses.append(np.stack(list(read_pose_file(
            tmp_path / f"{name}.txt").values())))
    np.testing.assert_allclose(poses[1], poses[0], atol=2e-3, rtol=0)
