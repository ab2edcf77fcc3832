"""PyTorch port: the line map (io/vectorize.py) and session checkpoints
(io/checkpoint.py) against the JAX package."""

import dataclasses

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.io import checkpoint as jckpt
from nautilus_tpu.io import vectorize as jvec
from nautilus_tpu.solve import hitl as jhitl
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.io import checkpoint as tckpt
from nautilus_tpu_torch.io import vectorize as tvec
from nautilus_tpu_torch.solve import hitl as thitl

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\nhitl_line_width=0.1\n"
       "hitl_pose_point_threshold=10\n")


def _port_state(js):
    """The port's state on exactly the JAX state's problem and solution."""
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    return ts


@pytest.fixture(scope="module", params=["office", "room"])
def solved(request):
    """A 24-pose map solved by the JAX package, and the port's state on its
    problem and solution."""
    js, _ = make_problem(24, request.param, num_beams=360, seed=1,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    JSolver(js, load_config_text(CFG)).solve_slam()
    return js, _port_state(js)


def _assert_same_segments(a, b):
    assert len(a) == len(b)
    for (a0, a1), (b0, b1) in zip(a, b):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_fused_cloud_matches_jax(solved):
    js, ts = solved
    cloud = tvec.fused_cloud(ts)
    assert cloud.dtype == np.float64
    np.testing.assert_array_equal(cloud, jvec.fused_cloud(js))


def test_vectorize_segments_match_jax(solved, tmp_path):
    js, ts = solved
    got = tvec.vectorize(ts, tmp_path / "t.csv", verbose=False)
    want = jvec.vectorize(js, tmp_path / "j.csv", verbose=False)
    assert len(got) >= 4          # the walls of the world
    _assert_same_segments(got, want)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_line_steps_match_jax(solved):
    """Each step on its own: extraction without merging, then merge_colinear,
    join_corners and polyline_chains on the same segments."""
    js, _ = solved
    cloud = jvec.fused_cloud(js)
    lines = tvec.extract_lines(cloud, seed=3, ransac_iters=30)
    _assert_same_segments(lines, jvec.extract_lines(cloud, seed=3,
                                                    ransac_iters=30))
    merged = tvec.merge_colinear(lines)
    _assert_same_segments(merged, jvec.merge_colinear(lines))
    joined = tvec.join_corners(merged)
    _assert_same_segments(joined, jvec.join_corners(merged))
    chains = tvec.polyline_chains(joined)
    want = jvec.polyline_chains(joined)
    assert len(chains) == len(want) > 0
    for c, w in zip(chains, want):
        np.testing.assert_array_equal(c, w)


@pytest.fixture(scope="module")
def curated():
    """A session with one HITL constraint (both lines selected), its line
    pose and two loop-closure factors, built the same way in both
    packages."""
    cfg = load_config_text(CFG)
    js, _ = make_problem(24, "office", num_beams=180, seed=0,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    js.solution[12:, 1] += 0.3
    ts = _port_state(js)
    lines = ((2.0, -2.0), (10.0, -2.0), (2.0, -1.7), (10.0, -1.7))
    js.hitl_constraints.append(jhitl.select_poses(
        js, jhitl.HitlSlamInputMsg.from_points(*lines), cfg))
    ts.hitl_constraints.append(thitl.select_poses(
        ts, thitl.HitlSlamInputMsg.from_points(*lines), cfg))
    for s in (js, ts):
        s.line_poses = np.array([[0.05, -0.03, 0.01]])
        s.lc_factors = [(2, 20, np.array([0.5, -1.25]), 0.125, 2.0, 1.5),
                        (5, 16, np.array([-3.0, 0.75]), -0.0625, 3.0, 3.0)]
    assert ts.hitl_constraints[0].line_a_poses
    assert ts.hitl_constraints[0].line_b_poses
    return js, ts


def _assert_same_session(a, b):
    np.testing.assert_array_equal(a.solution, b.solution)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    np.testing.assert_array_equal(a.line_poses, b.line_poses)
    assert len(a.hitl_constraints) == len(b.hitl_constraints)
    for ca, cb in zip(a.hitl_constraints, b.hitl_constraints):
        assert ca.line_pose_index == cb.line_pose_index
        for end_a, end_b in zip(ca.line_a + ca.line_b, cb.line_a + cb.line_b):
            np.testing.assert_array_equal(end_a, end_b)
        for pa, pb in ((ca.line_a_poses, cb.line_a_poses),
                       (ca.line_b_poses, cb.line_b_poses)):
            assert [k for k, _ in pa] == [k for k, _ in pb]
            for (_, xa), (_, xb) in zip(pa, pb):
                np.testing.assert_array_equal(xa, xb)
    assert len(a.lc_factors) == len(b.lc_factors)
    for fa, fb in zip(a.lc_factors, b.lc_factors):
        assert (fa[0], fa[1], fa[3], fa[4], fa[5]) == \
            (fb[0], fb[1], fb[3], fb[4], fb[5])
        np.testing.assert_array_equal(fa[2], fb[2])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(curated, tmp_path, saver):
    js, ts = curated
    path = tmp_path / "session.npz"
    (jckpt if saver == "jax" else tckpt).save_state(
        js if saver == "jax" else ts, path)
    # Load into blank sessions of the same problem, in both packages.
    fresh_t = _port_state(js)
    fresh_t.solution = np.zeros_like(js.solution)
    fresh_j = dataclasses.replace(js, solution=np.zeros_like(js.solution),
                                  hitl_constraints=[], lc_factors=[],
                                  line_poses=np.zeros((0, 3)))
    loaded_t = tckpt.load_state(fresh_t, path)
    assert loaded_t is fresh_t
    assert isinstance(loaded_t.hitl_constraints[0], thitl.HitlConstraint)
    _assert_same_session(loaded_t, ts)
    loaded_j = jckpt.load_state(fresh_j, path)
    assert isinstance(loaded_j.hitl_constraints[0], jhitl.HitlConstraint)
    _assert_same_session(loaded_j, js)
    # The restored session builds the same HITL rows as the original.
    rows, want = thitl.build_hitl_factors(loaded_t), \
        thitl.build_hitl_factors(ts)
    np.testing.assert_array_equal(rows.points.numpy(), want.points.numpy())
    np.testing.assert_array_equal(rows.node.numpy(), want.node.numpy())
