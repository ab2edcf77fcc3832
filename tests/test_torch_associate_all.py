"""PyTorch port: whole-cloud association (optimization type ALL) against the
JAX package and the pair-at-a-time oracle, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve import correspond as jcorr
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve import correspond as tcorr
from nautilus_tpu_torch.solve.solver import Solver as TSolver

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\n")


def _pair(n=10, seed=3):
    js, _ = make_problem(n, "office", num_beams=120, seed=seed,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    return js, ts


@pytest.fixture(scope="module")
def states():
    return _pair()


def _same(t, j, q):
    """Bitwise equal over the first q rows (the JAX result is padded to a
    chunk multiple): same matched indices, first index on ties."""
    jm = np.asarray(j.mask)[:q]
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.src.numpy(), np.asarray(j.src)[:q])
    np.testing.assert_array_equal(t.tgt_pts.numpy()[jm],
                                  np.asarray(j.tgt_pts)[:q][jm])
    np.testing.assert_array_equal(t.tgt_nrm.numpy()[jm],
                                  np.asarray(j.tgt_nrm)[:q][jm])
    np.testing.assert_array_equal(t.src_pts.numpy(),
                                  np.asarray(j.src_pts)[:q])
    assert jm.sum() > 0


@pytest.mark.parametrize("gate", [False, True])
def test_associate_all_bitwise(states, gate):
    js, ts = states
    x = js.solution.astype(np.float32)
    pairs = jcorr.make_pairs(js.num_nodes, 2)
    j = jcorr.associate(js.problem, jnp.asarray(x), jnp.asarray(pairs.src),
                        jnp.asarray(pairs.tgt), 2, 0.25, feature="all",
                        use_normal_gate=gate)
    t = tcorr.associate(ts.problem, torch.as_tensor(x),
                        torch.as_tensor(pairs.src, dtype=torch.int64),
                        torch.as_tensor(pairs.tgt, dtype=torch.int64), 2,
                        0.25, feature="all", use_normal_gate=gate)
    _same(t, j, len(pairs.src))


@pytest.mark.parametrize("chunk", [4, 7, 64])
def test_associate_chunked_matches_jax_and_unchunked(states, chunk):
    js, ts = states
    x = js.solution.astype(np.float32)
    jpairs = jcorr.make_pairs(js.num_nodes, 3)
    tpairs = tcorr.make_pairs(ts.num_nodes, 3)
    q = len(tpairs.src)
    j = jcorr.associate_chunked(js.problem, jnp.asarray(x), jpairs, 2, 0.25,
                                chunk=chunk)
    t = tcorr.associate_chunked(ts.problem, torch.as_tensor(x), tpairs, 2,
                                0.25, chunk=chunk)
    assert t.mask.shape[0] == q            # no padded pair in the port
    _same(t, j, q)
    whole = tcorr.associate(ts.problem, torch.as_tensor(x),
                            torch.as_tensor(tpairs.src),
                            torch.as_tensor(tpairs.tgt), 2, 0.25,
                            feature="all")
    for a, b in zip(t, whole):
        assert torch.equal(a, b)
    # Pairs beyond the window hold no match.
    beyond = (tpairs.src - tpairs.tgt) > 2
    assert beyond.any() and not t.mask.numpy()[beyond].any()


def test_associate_all_matches_the_pair_oracle(states):
    js, ts = states
    x = js.solution.astype(np.float32)
    pairs = tcorr.make_pairs(ts.num_nodes, 1)
    t = tcorr.associate_chunked(ts.problem, torch.as_tensor(x), pairs, 1,
                                0.25, chunk=4)
    p = js.problem
    for k in (0, 5):
        s, g = int(pairs.src[k]), int(pairs.tgt[k])
        tm, tn, valid = jcorr._match_pair(
            p.points[s], p.points_mask[s], p.normals[s], p.points[g],
            p.points_mask[g], p.normals[g], 0.25, 0.9396926,
            jnp.asarray(x[s]), jnp.asarray(x[g]), False)
        v = np.asarray(valid)
        np.testing.assert_array_equal(t.mask.numpy()[k], v)
        np.testing.assert_array_equal(t.tgt_pts.numpy()[k][v],
                                      np.asarray(tm)[v])
        np.testing.assert_array_equal(t.tgt_nrm.numpy()[k][v],
                                      np.asarray(tn)[v])


def test_ties_go_to_the_first_index(states):
    """Two identical target points: the lower index is matched."""
    _, ts = states
    prob = ts.problem
    pts = prob.points.clone()
    pts[0, 1] = pts[0, 0]
    nrm = prob.normals.clone()
    nrm[0, 0] = torch.tensor([1.0, 0.0])
    nrm[0, 1] = torch.tensor([0.0, 1.0])
    tied = prob._replace(points=pts, normals=nrm)
    x = torch.zeros((ts.num_nodes, 3))
    # Source node 1's first point sits exactly on the doubled target point.
    pts2 = tied.points.clone()
    pts2[1, 0] = pts[0, 0]
    tied = tied._replace(points=pts2)
    out = tcorr.associate(tied, x, torch.tensor([1]), torch.tensor([0]), 1,
                          0.25, feature="all")
    assert bool(out.mask[0, 0])
    assert torch.equal(out.tgt_nrm[0, 0], torch.tensor([1.0, 0.0]))


def test_solve_slam_all_matches_jax():
    cfg = load_config_text(CFG)
    js, ts = _pair(n=8, seed=5)
    jstats = JSolver(js, cfg).solve_slam(optimization_type="all")
    tstats = TSolver(ts, cfg).solve_slam(optimization_type="all")
    assert [w.window for w in tstats.windows] == [1, 2, 3]
    for jw, tw in zip(jstats.windows, tstats.windows):
        assert tw.final_cost <= tw.initial_cost
        np.testing.assert_allclose(tw.initial_cost, jw.initial_cost,
                                   rtol=1e-3)
        np.testing.assert_allclose(tw.final_cost, jw.final_cost, rtol=1e-3)
    np.testing.assert_allclose(ts.solution, js.solution, atol=2e-3, rtol=0)
    graph = TSolver(ts, cfg).build_graph(TSolver(ts, cfg)._current_x(), 2,
                                         "all")
    assert graph.planar.src.shape[0] == 0
    assert graph.edge.src_pts.shape[1] == ts.problem.points.shape[1]
    with pytest.raises(ValueError, match="optimization_type"):
        TSolver(ts, cfg).solve_slam(optimization_type="some")
