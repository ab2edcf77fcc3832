"""PyTorch port: automatic loop closure against the JAX package on the
reverse-traversal scenario (a closure at relative heading ~pi)."""

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import reverse_traversal_problem as jax_rt
from nautilus_tpu.kernels.csm import CSMParams as JParams
from nautilus_tpu.loop_closure.auto_lc import solve_auto_lc as jax_auto_lc
from nautilus_tpu.loop_closure.keyframes import \
    candidate_uncertainty_ok as jax_uncertainty_ok
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
from nautilus_tpu_torch.kernels import csm_coarse
from nautilus_tpu_torch.kernels.csm import CSMParams
from nautilus_tpu_torch.loop_closure.auto_lc import (relative_pose_factor,
                                                     solve_auto_lc)
from nautilus_tpu_torch.loop_closure.keyframes import candidate_uncertainty_ok
from nautilus_tpu_torch.solve.solver import Solver

CFG = """
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


@pytest.fixture(scope="module")
def runs():
    cfg = load_config_text(CFG)
    js, gt = jax_rt(3)
    jsolver = JSolver(js, cfg)
    jsolver.solve_slam()
    solved_j = js.solution.copy()
    jrep = jax_auto_lc(jsolver, apply=True, verbose=False,
                       csm_params=JParams(scan_range=10.0, high_res=0.05))
    ts, _ = reverse_traversal_problem(3, device="cpu")
    tsolver = Solver(ts, cfg)
    tsolver.solve_slam()
    solved_t = ts.solution.copy()
    before = csm_coarse.fused_coarse.launches
    trep = solve_auto_lc(tsolver, apply=True, verbose=False,
                         csm_params=CSMParams(scan_range=10.0, high_res=0.05))
    assert csm_coarse.fused_coarse.launches == before   # CPU: plain version
    return cfg, (js, jrep, solved_j), (ts, trep, solved_t), gt


def test_auto_lc_sets_match_jax(runs):
    _, (js, jrep, _), (ts, trep, _), gt = runs
    assert trep.candidates == jrep.candidates
    assert trep.gated_pairs == jrep.gated_pairs
    assert trep.accepted == jrep.accepted
    assert trep.accepted, "the reverse traversal must close"
    cross = [(s, t) for s, t in trep.accepted if (s <= 18) != (t <= 18)]
    assert cross
    for (s, t, sc, tr), (s2, t2, sc2, tr2) in zip(trep.csm_results,
                                                  jrep.csm_results):
        assert (s, t) == (s2, t2)
        np.testing.assert_allclose(sc, sc2, atol=1e-4)
        np.testing.assert_allclose(tr, tr2, atol=0.05 + 1e-6)
    assert trep.applied and len(ts.lc_factors) == len(trep.accepted)
    assert set(trep.stage_walls) >= {"candidates", "gate", "csm", "resolve"}


def test_auto_lc_poses_match_jax(runs):
    _, (js, _, solved_j), (ts, _, solved_t), gt = runs
    # Float32 solves in two frameworks: summation order and
    # transcendental last bits.
    np.testing.assert_allclose(solved_t, solved_j, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.solution, js.solution, atol=1e-3, rtol=0)
    err = np.abs(ts.solution[:, :2] - gt[:, :2]).mean()
    assert err < 0.3, err


def test_candidate_uncertainty_matches_jax(runs):
    cfg, (js, _, _), (ts, _, _), _ = runs
    nodes = list(range(0, 32, 3))
    np.testing.assert_array_equal(candidate_uncertainty_ok(ts, cfg, nodes),
                                  jax_uncertainty_ok(js, cfg, nodes))


def test_relative_pose_factor_identity():
    ts, _ = reverse_traversal_problem(3, device="cpu")
    ts.solution[4] = ts.solution[2].copy()
    i, j, trans, rot, wt, wr = relative_pose_factor(ts, 4, 2, np.zeros(3),
                                                    1.0, 1.0)
    assert (i, j) == (2, 4)
    np.testing.assert_allclose(trans, 0.0, atol=1e-12)
    assert rot == pytest.approx(0.0)


def test_descriptor_gate_not_ported(runs):
    cfg, _, (ts, _, _), _ = runs
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_auto_lc(Solver(ts, cfg), use_descriptor_gate=True)
