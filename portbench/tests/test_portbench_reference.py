"""The benchmark's frozen inputs and plain reference, held to the port's
code they were frozen from: the input maker to the port's synthesize, the
features to the port's preprocessing, the referee to the port's float64
CPU referee (baseline/) at rtol 1e-12, and the scan-match twin to the
port's CPU twin."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.reference import csm, features, gate, referee, world  # noqa

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
N = 48


@pytest.fixture(scope="module")
def scans():
    return world.synthesize(N, "building", 720, 8.5, 0.02, 0.008, SEED)


@pytest.fixture(scope="module")
def feats(scans):
    return features.compute(scans.points, scans.points_mask)


@pytest.fixture(scope="module")
def baseline_problem(scans, feats):
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    m = scans.points_mask
    return cpu.CpuProblem(
        points=[scans.points[i][m[i]].astype(np.float64) for i in range(N)],
        normals=[feats.normals[i][m[i]] for i in range(N)],
        planar_idx=[feats.planar_idx[i][feats.planar_mask[i]]
                    for i in range(N)],
        edge_idx=[feats.edge_idx[i][feats.edge_mask[i]] for i in range(N)],
        odom_i=scans.odom_i, odom_j=scans.odom_j,
        odom_trans=scans.odom_trans, odom_rot=scans.odom_rot)


class _Cfg:
    """The baseline referee's view of a configuration."""

    def __init__(self, **keys):
        self.keys = keys

    def __getattr__(self, name):
        return self.keys[name]

    def get_int(self, name):
        return int(self.keys[name])

    def get(self, name, default=None):
        return self.keys.get(name, default)


KEYS = dict(translation_weight=2.0, rotation_weight=1.0, outlier_threshold=0.25,
            lidar_constraint_amount_min=1, lidar_constraint_amount_max=10,
            accuracy_change_stop_threshold=0.0001)


@pytest.mark.parametrize("kind,beams,rng", [("building", 720, 8.5),
                                            ("office", 360, 30.0)])
def test_input_maker_equals_the_ports_synthesize(kind, beams, rng):
    from nautilus_tpu_torch.ingest.synthetic import synthesize
    ours = world.synthesize(40, kind, beams, rng, 0.02, 0.008, SEED)
    raw, gt = synthesize(40, kind, num_beams=beams, max_range=rng,
                         odom_noise_trans=0.02, odom_noise_rot=0.008,
                         seed=SEED)
    for name in ("points", "points_mask", "initial_poses", "timestamps",
                 "odom_i", "odom_j", "odom_trans", "odom_rot"):
        assert np.array_equal(getattr(ours, name), getattr(raw, name)), name
    assert np.array_equal(ours.gt, gt)


def test_features_equal_the_ports_preprocessing(scans, feats):
    from nautilus_tpu_torch.core.preprocess import preprocess
    nrm, pidx, pmask, eidx, emask, _ = preprocess(
        scans.points, scans.points_mask, "cpu")
    for ours, port in ((feats.planar_idx, pidx), (feats.planar_mask, pmask),
                       (feats.edge_idx, eidx), (feats.edge_mask, emask)):
        assert np.array_equal(ours, port.numpy())
    m = scans.points_mask
    np.testing.assert_allclose(feats.normals[m], nrm.numpy()[m], atol=1e-6)


@pytest.mark.parametrize("window", [1, 4, 10])
def test_referee_equals_the_baseline(scans, feats, baseline_problem, window):
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    prob = referee.make_problem(scans.points, scans.points_mask, feats)
    odo = referee.odometry(scans.odom_i, scans.odom_j, scans.odom_trans,
                           scans.odom_rot, 2.0, 1.0)
    x = scans.initial_poses + np.random.default_rng(0).normal(
        scale=0.01, size=(N, 3))
    pl, ed = referee.associate(prob, x, window, 0.25)
    bl, be = cpu.associate(baseline_problem, x, window, 0.25)
    assert int(pl.keep.sum()) == sum(len(c["src_pts"]) for c in bl)
    assert int(ed.keep.sum()) == sum(len(c["src_pts"]) for c in be)
    blocks = referee.evaluate(prob, x, pl, ed, odo)
    c = referee.cost_of(blocks)
    np.testing.assert_allclose(
        c, cpu.total_cost(baseline_problem, x, bl, be, 2.0, 1.0), rtol=1e-12)
    H, g = referee.normal_equations(blocks, N)
    J, r = cpu.build_system(baseline_problem, x, bl, be, 2.0, 1.0)
    scale = np.abs((J.T @ J).toarray()).max()
    assert np.abs(H.toarray() - (J.T @ J).toarray()).max() <= 1e-12 * scale
    np.testing.assert_allclose(g, J.T @ r, rtol=1e-12,
                               atol=1e-12 * np.abs(J.T @ r).max())


def test_sweep_equals_the_baseline(scans, feats, baseline_problem):
    from nautilus_tpu_torch.baseline import cpu_reference as cpu
    prob = referee.make_problem(scans.points, scans.points_mask, feats)
    cfg = referee.Settings.from_keys(KEYS)
    odo = referee.odometry(scans.odom_i, scans.odom_j, scans.odom_trans,
                           scans.odom_rot, cfg.tw, cfg.rw)
    x, costs = referee.sweep(prob, scans.initial_poses, cfg, odo)
    xb, stats = cpu.solve_slam(baseline_problem, scans.initial_poses,
                               _Cfg(**KEYS))
    np.testing.assert_allclose(costs, [w["cost"] for w in stats.windows],
                               rtol=1e-12)
    np.testing.assert_allclose(x, xb, rtol=0, atol=1e-10)


def test_csm_twin_equals_the_ports_twin(scans):
    from nautilus_tpu_torch.baseline import cpu_csm
    from nautilus_tpu_torch.kernels.csm import CSMParams
    m = scans.points_mask
    for s, t, center in ((5, 0, 0.1), (30, 20, -0.3)):
        a, b = scans.points[s][m[s]], scans.points[t][m[t]]
        ours = csm.csm_match_cpu(a, b, csm.CSMParams(scan_range=8.5), center)
        theirs = cpu_csm.csm_match_cpu(a, b, CSMParams(scan_range=8.5),
                                       center)
        assert ours[0] == theirs[0]
        assert np.array_equal(ours[1], theirs[1])


def test_gate_scores_are_the_dense_inverse(scans, feats):
    """The sparse gauged solve gives the cross block of the dense inverse."""
    prob = referee.make_problem(scans.points, scans.points_mask, feats)
    cfg = referee.Settings.from_keys(KEYS)
    odo = referee.odometry(scans.odom_i, scans.odom_j, scans.odom_trans,
                           scans.odom_rot, cfg.tw, cfg.rw)
    x = scans.initial_poses
    pairs = [(3, 40), (10, 30)]
    got = gate.chi_square(prob, x, cfg, odo, pairs)
    pl, ed = referee.associate(prob, x, cfg.w_max, cfg.outlier)
    H, _ = referee.normal_equations(referee.evaluate(prob, x, pl, ed, odo), N)
    for s, t in pairs:
        f = (np.arange(3 * N) // 3) == max(min(s, t) - 1, 0)
        Hg = H.toarray() * np.outer(~f, ~f) + np.diag(f + 1e-8)
        cov = np.linalg.inv(Hg)[3 * s:3 * s + 2, 3 * t:3 * t + 2]
        d = x[t, :2] - x[s, :2]
        np.testing.assert_allclose(got[(s, t)], d @ np.linalg.inv(cov) @ d,
                                   rtol=1e-6)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("nautilus_tpu", "jax", "torch"):
            assert f"import {name}" not in text, (path, name)
            assert f"from {name}" not in text, (path, name)
