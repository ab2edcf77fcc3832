"""PyTorch port: keyframe selection, the merged-neighbourhood uncertainty,
the uncertainty filter, and the two library scan-match calls (best scan
match, matching grouped by target) against the JAX package on the same
numpy problems.

Keyframe masks and pairs are compared for equality.  The uncertainty
scale agrees within rtol 1e-5.  The condition number is an eigenvalue ratio
whose smaller eigenvalue cancels: on these inputs the JAX package's float32
value is itself 1.6e-5 from a float64 evaluation of the same formula and
the port's 2.8e-6, so the port is held within 1e-5 of the float64
evaluation and within 3e-5 of JAX.  CSM scores agree within 1e-4 and
transforms within the finest grid step, the bars of tests/test_torch_csm.py.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text as jload
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.kernels import csm as jcsm
from nautilus_tpu.loop_closure import auto_lc as jauto
from nautilus_tpu.loop_closure import keyframes as jkf
from nautilus_tpu.loop_closure import learned as jlearned
from nautilus_tpu_torch.core.luaconf import load_config_text as tload
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.kernels import csm as tcsm
from nautilus_tpu_torch.kernels.csm_correlate import correlate
from nautilus_tpu_torch.loop_closure import auto_lc as tauto
from nautilus_tpu_torch.loop_closure import keyframes as tkf
from nautilus_tpu_torch.loop_closure import learned as tlearned

KW = dict(scan_range=10.0, high_res=0.05)
GRID_T, GRID_R = 0.05 + 1e-6, 0.005 + 1e-6


def _pair(num_nodes, seed, num_beams=540, world="office"):
    """The same problem in both packages: (JAX state, port state)."""
    js, _ = make_problem(num_nodes=num_nodes, world_kind=world,
                         num_beams=num_beams, seed=seed)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    return js, ts


@pytest.fixture(scope="module")
def office():
    return _pair(20, seed=2)


@pytest.fixture(scope="module")
def office12():
    return _pair(12, seed=2)


def _unit_steps(state):
    state.solution[:, 0] = np.arange(state.num_nodes, dtype=np.float32)
    state.solution[:, 1:] = 0.0


POLICIES = {
    "spacing": ("keyframe_min_odom_distance=1.0\n"
                "keyframe_local_uncertainty_filtering=false\n", None),
    "uncertainty default": ("keyframe_min_odom_distance=0.1\n"
                            "keyframe_local_uncertainty_filtering=true\n",
                            None),
    "uncertainty strict": ("keyframe_min_odom_distance=0.1\n"
                           "keyframe_local_uncertainty_filtering=true\n"
                           "local_uncertainty_condition_threshold=1.0001\n"
                           "local_uncertainty_scale_threshold=0.0001\n",
                           None),
    "chi2 weak": ("keyframe_chi_squared_test=true\n"
                  "keyframe_local_uncertainty_filtering=false\n"
                  "keyframe_min_odom_distance=0.0\ntranslation_weight=1.0\n",
                  _unit_steps),
    "chi2 strong": ("keyframe_chi_squared_test=true\n"
                    "keyframe_local_uncertainty_filtering=false\n"
                    "keyframe_min_odom_distance=0.0\n"
                    "translation_weight=10.0\n", _unit_steps),
    "chi2 stationary": ("keyframe_chi_squared_test=true\n"
                        "keyframe_local_uncertainty_filtering=false\n"
                        "translation_weight=1.0\n",
                        lambda s: s.solution.__setitem__(
                            (slice(None), slice(None)),
                            np.stack([0.01 * np.arange(s.num_nodes),
                                      np.zeros(s.num_nodes),
                                      np.zeros(s.num_nodes)], 1))),
    "chi2 with uncertainty": ("keyframe_chi_squared_test=true\n"
                              "keyframe_local_uncertainty_filtering=true\n"
                              "keyframe_chi_squared_confidence=0.5\n", None),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_select_keyframes_matches_jax(office12, policy):
    text, prepare = POLICIES[policy]
    js, ts = office12
    jsol, tsol = js.solution.copy(), ts.solution.copy()
    try:
        if prepare is not None:
            prepare(js)
            prepare(ts)
        want = jkf.select_keyframes(js, jload(text))
        got = tkf.select_keyframes(ts, tload(text))
    finally:
        js.solution, ts.solution = jsol, tsol
    assert got.dtype == bool and got.shape == (12,)
    np.testing.assert_array_equal(got, want)
    if policy == "chi2 weak":
        assert list(np.nonzero(got)[0]) == [0, 6]
    if policy == "uncertainty strict":
        assert not got.any()


def test_spacing_policy_on_a_longer_run_matches_jax(office):
    js, ts = office
    text = "keyframe_min_odom_distance=1.0\n" \
           "keyframe_local_uncertainty_filtering=false\n"
    got = tkf.select_keyframes(ts, tload(text))
    np.testing.assert_array_equal(got, jkf.select_keyframes(js, jload(text)))
    locs = ts.solution[np.nonzero(got)[0], :2]
    assert np.all(np.linalg.norm(np.diff(locs, axis=0), axis=-1) >= 1.0 - 1e-9)


@pytest.mark.parametrize("gap", [0, 1, 2, 5])
def test_keyframe_pairs_matches_jax(gap):
    kf = np.zeros(12, bool)
    kf[[0, 2, 3, 6, 8, 11]] = True
    assert tkf.keyframe_pairs(kf, gap) == jkf.keyframe_pairs(kf, gap)


@pytest.mark.parametrize("prev_scans", [0, 2])
def test_batched_local_uncertainty_matches_jax(office, prev_scans):
    js, ts = office
    rng = np.random.default_rng(prev_scans)
    moved = js.solution + rng.normal(scale=[0.05, 0.05, 0.02],
                                     size=js.solution.shape)
    jsol, tsol = js.solution, ts.solution
    js.solution, ts.solution = moved, moved.copy()
    arrays = {f: getattr(ts.problem, f).numpy() for f in ts.problem._fields}
    ts64 = SLAMState.from_problem(problem_from_numpy(
        {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in arrays.items()}, "cpu", dtype=torch.float64))
    ts64.solution = moved.copy()
    try:
        wc, ws = jkf._batched_local_uncertainty(js, prev_scans)
        gc, gs = tkf._batched_local_uncertainty(ts, prev_scans)
        rc, rs = tkf._batched_local_uncertainty(ts64, prev_scans)
    finally:
        js.solution, ts.solution = jsol, tsol
    assert gc.shape == gs.shape == (20,)
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    np.testing.assert_allclose(gs, rs, rtol=1e-5)
    np.testing.assert_allclose(gc, rc, rtol=1e-5)
    np.testing.assert_allclose(gc, wc, rtol=3e-5)
    # The per-candidate criterion scores the same neighbourhoods.
    cfg = tload(f"local_uncertainty_prev_scans={prev_scans}\n"
                "local_uncertainty_condition_threshold=3.0\n")
    nodes = [0, 1, 5, 19]
    ok = tkf.candidate_uncertainty_ok(ts, cfg, nodes)
    np.testing.assert_array_equal(
        ok, jkf.candidate_uncertainty_ok(js, jload(
            f"local_uncertainty_prev_scans={prev_scans}\n"
            "local_uncertainty_condition_threshold=3.0\n"), nodes))


@pytest.mark.parametrize("scale", [2.5, 1.2])
def test_passes_uncertainty_filter_matches_jax(office12, scale):
    js, ts = office12
    text = (f"local_uncertainty_condition_threshold=3.0\n"
            f"local_uncertainty_scale_threshold={scale}\n")
    jcfg, tcfg = jload(text), tload(text)
    got, want = [], []
    for k in range(12):
        got.append(tlearned.passes_uncertainty_filter(
            ts.problem.points[k], ts.problem.points_mask[k],
            ts.problem.normals[k], tcfg))
        want.append(jlearned.passes_uncertainty_filter(
            js.problem.points[k], js.problem.points_mask[k],
            js.problem.normals[k], jcfg))
    assert all(isinstance(g, bool) for g in got)
    assert got == want


def test_best_scan_match_matches_jax(office):
    js, ts = office
    before = correlate.launches
    for source, scans in ((0, [1, 2, 3, 0]), (10, [8, 9, 11, 12, 19])):
        wscore, widx, wtr = jauto.best_scan_match(
            js, source, scans, jcsm.CSMParams(**KW))
        gscore, gidx, gtr = tauto.best_scan_match(
            ts, source, scans, tcsm.CSMParams(**KW))
        assert gidx == widx and gidx != source
        assert abs(gscore - wscore) < 1e-4
        np.testing.assert_allclose(gtr[:2], wtr[:2], atol=GRID_T, rtol=0)
        assert abs(gtr[2] - wtr[2]) < GRID_R
    assert correlate.launches == before        # CPU: the plain version
    score, idx, tr = tauto.best_scan_match(ts, 3, [3])
    assert (score, idx) == (float("-inf"), -1) and not tr.any()


def test_csm_match_grouped_matches_jax(office):
    js, ts = office
    src = np.array([1, 2, 4, 7, 9, 13])
    tgt = np.array([0, 0, 5, 5, 5, 12])
    ws, wtr = jcsm.csm_match_grouped(js.problem.points, js.problem.points_mask,
                                     src, tgt, jcsm.CSMParams(**KW))
    gs, gtr = tcsm.csm_match_grouped(ts.problem.points, ts.problem.points_mask,
                                     src, tgt, tcsm.CSMParams(**KW))
    assert gs.shape == (6,) and gtr.shape == (6, 3)
    np.testing.assert_allclose(gs, np.asarray(ws), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gtr[:, :2], np.asarray(wtr)[:, :2],
                               atol=GRID_T, rtol=0)
    np.testing.assert_allclose(gtr[:, 2], np.asarray(wtr)[:, 2],
                               atol=GRID_R, rtol=0)
    # Grouping changes nothing: the pair engine on the same pairs.
    ps, ptr = tcsm.csm_match_pairs(ts.problem.points, ts.problem.points_mask,
                                   src, tgt, tcsm.CSMParams(**KW),
                                   engine="pair")
    np.testing.assert_allclose(gs, ps, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gtr, ptr, atol=1e-5, rtol=0)
    es, etr = tcsm.csm_match_grouped(ts.problem.points,
                                     ts.problem.points_mask, [], [])
    assert es.shape == (0,) and etr.shape == (0, 3)
