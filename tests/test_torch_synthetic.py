"""PyTorch port: synthetic ingest and problem construction against the JAX
package (host numpy must be bit-identical for the same seed)."""

import numpy as np
import pytest
import torch

from nautilus_tpu.ingest import synthetic as jsyn
from nautilus_tpu_torch.core.problem import (SLAMProblem, SLAMState,
                                             problem_from_numpy)
from nautilus_tpu_torch.ingest import synthetic as tsyn


@pytest.mark.parametrize("kind,n,beams,seed", [
    ("office", 24, 180, 0), ("building", 30, 360, 1), ("room", 12, 360, 4),
    ("corner", 6, 180, 2)])
def test_synthesize_identical(kind, n, beams, seed):
    raw_j, gt_j = jsyn.synthesize(n, kind, num_beams=beams, seed=seed,
                                  odom_noise_trans=0.02)
    raw_t, gt_t = tsyn.synthesize(n, kind, num_beams=beams, seed=seed,
                                  odom_noise_trans=0.02)
    np.testing.assert_array_equal(gt_j, gt_t)
    for name in raw_j._fields:
        np.testing.assert_array_equal(getattr(raw_j, name),
                                      getattr(raw_t, name), err_msg=name)


def _numpy_fields(problem):
    return {f: np.asarray(getattr(problem, f)) for f in problem._fields}


def test_make_problem_identical():
    js, gt_j = jsyn.make_problem(24, "office", num_beams=180, seed=0)
    ts, gt_t = tsyn.make_problem(24, "office", num_beams=180, seed=0,
                                 device="cpu")
    np.testing.assert_array_equal(gt_j, gt_t)
    jf = _numpy_fields(js.problem)
    for name in SLAMProblem._fields:
        got = getattr(ts.problem, name).numpy()
        if name == "normals":
            # PCA normals: float32 eigenvector arithmetic, last-bit
            # differences between the two frameworks' transcendentals.
            np.testing.assert_allclose(got, jf[name], atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got, jf[name], err_msg=name)
    np.testing.assert_array_equal(js.solution, ts.solution)
    np.testing.assert_array_equal(js.timestamps, ts.timestamps)
    assert ts.solution.dtype == np.float64


def test_problem_from_numpy_round_trip():
    js, _ = jsyn.make_problem(10, "room", num_beams=180, seed=1)
    arrays = _numpy_fields(js.problem)
    prob = problem_from_numpy(arrays, "cpu")
    for name in SLAMProblem._fields:
        t = getattr(prob, name)
        np.testing.assert_array_equal(t.numpy(), arrays[name], err_msg=name)
    assert prob.points.dtype == torch.float32
    assert prob.planar_idx.dtype == torch.int64
    assert prob.points_mask.dtype == torch.bool
    state = SLAMState.from_problem(prob, js.timestamps)
    np.testing.assert_array_equal(state.solution, js.solution)
    # Gathered feature views agree with the JAX properties.
    np.testing.assert_array_equal(prob.planar_points.numpy(),
                                  np.asarray(js.problem.planar_points))
    np.testing.assert_array_equal(prob.edge_normals.numpy(),
                                  np.asarray(js.problem.edge_normals))
