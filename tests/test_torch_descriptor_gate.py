"""PyTorch port: the scan descriptor, the learned embedding with the shipped
weights, and the descriptor gate against the JAX package on the same numpy
scans.

Scores are held to atol 1e-5, with one allowance: a point whose polar angle
or range lies within rounding of a bin edge (the +-pi seam of arctan2
included) may fall in the neighbouring bin on the other backend.  That
moves one point's vote out of ~120-240, so a histogram may differ in two
cells by one count before normalization; the tests count such scans and
find none on these worlds.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu.core.luaconf import load_config_text
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.loop_closure import auto_lc as jauto
from nautilus_tpu.loop_closure import embedding as jemb
from nautilus_tpu.loop_closure import learned as jlearned
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.loop_closure import auto_lc as tauto
from nautilus_tpu_torch.loop_closure import embedding as temb
from nautilus_tpu_torch.loop_closure import learned as tlearned
from nautilus_tpu_torch.solve.solver import Solver as TSolver

ATOL = 1e-5
PAIRS = [(0, 1), (3, 4), (0, 20), (5, 31), (12, 13), (2, 27), (9, 9)]


@pytest.fixture(scope="module")
def states():
    js, _ = make_problem(32, "building", num_beams=240, seed=2,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    return js, ts


def test_weight_files_are_equal_byte_for_byte():
    a, b = jemb.default_weights_path(), temb.default_weights_path()
    assert a != b and b.parent.parent.name == "loop_closure"
    assert "nautilus_tpu_torch" in b.parts
    assert a.read_bytes() == b.read_bytes()
    assert len(b.read_bytes()) == 305084


def test_load_and_save_params_round_trip(tmp_path):
    params = temb.load_params()
    jparams = jemb.load_params()
    assert set(params) == set(jparams) == {"w1", "b1", "w2", "b2", "calib"}
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    path = temb.save_params(params, tmp_path / "w.npz")
    back = temb.load_params(path)
    assert all(torch.equal(back[k], params[k]) for k in params)
    # Either package reads the other's file.
    assert set(jemb.load_params(path)) == set(params)
    assert temb.load_params(tmp_path / "absent.npz") is None
    np.savez(tmp_path / "bad.npz", w1=np.zeros(1))
    with pytest.raises(ValueError, match="weights file"):
        temb.load_params(tmp_path / "bad.npz")


def test_scan_descriptor_matches_jax(states):
    js, ts = states
    moved = 0
    for k in range(0, 32, 3):
        jd = np.asarray(jlearned.scan_descriptor(js.problem.points[k],
                                                 js.problem.points_mask[k]))
        td = tlearned.scan_descriptor(ts.problem.points[k],
                                      ts.problem.points_mask[k]).numpy()
        assert td.shape == (tlearned.RANGE_BINS, tlearned.THETA_BINS)
        if np.abs(td - jd).max() > ATOL:
            moved += 1
        np.testing.assert_allclose(np.sum(td * td), 1.0, atol=1e-5)
    assert moved == 0


def test_normalize_cloud_matches_jax(states):
    js, ts = states
    jn = np.asarray(jlearned.normalize_cloud(js.problem.points[4],
                                             js.problem.points_mask[4], 10.0))
    tn = tlearned.normalize_cloud(ts.problem.points[4],
                                  ts.problem.points_mask[4], 10.0).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0)


def test_match_score_matches_jax(states):
    js, ts = states
    jp, jm = js.problem.points, js.problem.points_mask
    tp, tm = ts.problem.points, ts.problem.points_mask
    for s, t in PAIRS:
        want = float(jlearned.match_score(jp[s], jm[s], jp[t], jm[t]))
        got = float(tlearned.match_score(tp[s], tm[s], tp[t], tm[t]))
        assert got == pytest.approx(want, abs=ATOL), (s, t)
    assert float(tlearned.match_score(tp[9], tm[9], tp[9], tm[9])) \
        == pytest.approx(1.0, abs=ATOL)


def test_match_score_is_rotation_invariant(states):
    """A scan rotated by a whole number of angle bins scores ~1 against
    itself (up to points that change range/angle bin under rounding)."""
    _, ts = states
    p, m = ts.problem.points[6], ts.problem.points_mask[6]
    a = 2 * np.pi * 5 / tlearned.THETA_BINS
    c, s = np.cos(a), np.sin(a)
    # Rotate about the centroid the descriptor centres on.
    mean = p[m].mean(0)
    q = (p - mean) @ torch.tensor([[c, s], [-s, c]], dtype=p.dtype) + mean
    assert float(tlearned.match_score(p, m, q, m)) > 0.9


def test_spectral_features_and_embed_match_jax(states):
    js, ts = states
    jparams, tparams = jemb.load_params(), temb.load_params()
    for k in (0, 7, 19, 31):
        jf = np.asarray(jemb.spectral_features(js.problem.points[k],
                                               js.problem.points_mask[k]))
        tf = temb.spectral_features(ts.problem.points[k],
                                    ts.problem.points_mask[k])
        assert tf.shape == (temb.FEAT_DIM,) == (528,)
        np.testing.assert_allclose(tf.numpy(), jf, atol=ATOL, rtol=0)
        jz = np.asarray(jemb.embed(jparams, js.problem.points[k],
                                   js.problem.points_mask[k]))
        tz = temb.embed(tparams, ts.problem.points[k],
                        ts.problem.points_mask[k]).numpy()
        assert tz.shape == (temb.EMBED_DIM,)
        np.testing.assert_allclose(tz, jz, atol=ATOL, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(tz), 1.0, atol=1e-5)
    # tanh GELU, jax.nn.gelu's default: the exact erf form differs by up to
    # ~5e-4 per activation, far above ATOL.
    feats = np.random.default_rng(0).random((3, 528)).astype(np.float32)
    np.testing.assert_allclose(
        temb.embed_features(tparams, torch.as_tensor(feats)).numpy(),
        np.asarray(jemb.embed_features(jparams, feats)), atol=ATOL, rtol=0)


def test_embedding_match_score_matches_jax(states):
    js, ts = states
    jparams, tparams = jemb.load_params(), temb.load_params()
    jp, jm = js.problem.points, js.problem.points_mask
    tp, tm = ts.problem.points, ts.problem.points_mask
    scores = []
    for s, t in PAIRS:
        want = float(jemb.embedding_match_score(jparams, jp[s], jm[s], jp[t],
                                                jm[t]))
        got = float(temb.embedding_match_score(tparams, tp[s], tm[s], tp[t],
                                               tm[t]))
        assert got == pytest.approx(want, abs=ATOL), (s, t)
        scores.append(got)
    assert scores[-1] == pytest.approx(1.0, abs=ATOL)      # a self pair
    # Without a calibration scalar the remap's middle anchor is 0.5.
    plain = {k: v for k, v in tparams.items() if k != "calib"}
    jplain = {k: v for k, v in jparams.items() if k != "calib"}
    want = float(jemb.embedding_match_score(jplain, jp[0], jm[0], jp[20],
                                            jm[20]))
    got = float(temb.embedding_match_score(plain, tp[0], tm[0], tp[20],
                                           tm[20]))
    assert got == pytest.approx(want, abs=ATOL)


def test_scorer_self_check_matches_jax(states):
    js, ts = states
    jp, jm = js.problem.points, js.problem.points_mask
    tp, tm = ts.problem.points, ts.problem.points_mask
    jauc = jauto.scorer_self_check(
        js, lambda s, t: jlearned.match_score(jp[s], jm[s], jp[t], jm[t]))
    tauc = tauto.scorer_self_check(
        ts, lambda s, t: tlearned.match_score(tp[s], tm[s], tp[t], tm[t]))
    assert tauc is not None and tauc == jauc
    tiny = SLAMState(problem=ts.problem, solution=ts.solution[:4],
                     timestamps=ts.timestamps[:4])
    assert tauto.scorer_self_check(tiny, lambda s, t: 1.0) is None


@pytest.mark.parametrize("learned", [None, True, False])
def test_descriptor_gate_keeps_the_same_pairs(states, learned):
    js, ts = states
    js.__dict__.pop("_descriptor_gate_choice", None)
    ts.__dict__.pop("_descriptor_gate_choice", None)
    pairs = [(s, t) for s in range(0, 32, 4) for t in range(s + 1, 32, 5)]
    for threshold in (0.4, 0.5, 0.6):
        want = jauto.descriptor_gate(js, pairs, threshold, learned)
        got = tauto.descriptor_gate(ts, pairs, threshold, learned)
        assert got == want
    assert 0 < len(got) < len(pairs)
    if learned is None:
        choice = ts._descriptor_gate_choice
        assert choice["scorer"] == js._descriptor_gate_choice
        assert 0.0 <= choice["auc_emb"] <= 1.0
        assert 0.0 <= choice["auc_hand"] <= 1.0
    assert tauto.descriptor_gate(ts, [], 0.5, learned) == []


def test_descriptor_gate_without_weights(states, monkeypatch, tmp_path):
    _, ts = states
    monkeypatch.setattr(temb, "_WEIGHTS_PATH", tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="lc_use_learned_embedding"):
        tauto.descriptor_gate(ts, [(0, 1)], 0.5, True)
    # Auto without a weights file: the hand descriptor scores.
    hand = tauto.descriptor_gate(ts, [(0, 1), (0, 20)], 0.5, False)
    assert tauto.descriptor_gate(ts, [(0, 1), (0, 20)], 0.5, None) == hand


def test_descriptor_gate_on_a_float64_problem(states):
    js, ts = states
    arrays = {f: getattr(ts.problem, f).numpy() for f in ts.problem._fields}
    t64 = SLAMState.from_problem(
        problem_from_numpy(arrays, "cpu", torch.float64), ts.timestamps)
    pairs = [(0, 1), (0, 20), (5, 31), (12, 13)]
    assert tauto.descriptor_gate(t64, pairs, 0.5, True) \
        == tauto.descriptor_gate(ts, pairs, 0.5, True)


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
lc_match_threshold=0.5
accuracy_change_stop_threshold=0.0001
"""


def test_solve_auto_lc_with_descriptor_gate_matches_jax(tmp_path):
    """The gate inside solve_auto_lc (apply=False): the same gated pairs
    survive in both packages, and lc_debug_output_dir receives one picture
    per scored pair."""
    from nautilus_tpu.ingest.synthetic import reverse_traversal_problem as jrt
    from nautilus_tpu.kernels.csm import CSMParams as JParams
    from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
    from nautilus_tpu_torch.kernels.csm import CSMParams
    debug = tmp_path / "lc_debug"
    debug.mkdir()
    cfg = load_config_text(CFG + f'lc_debug_output_dir="{debug}"\n')
    js, _ = jrt(3)
    jsolver = JSolver(js, load_config_text(CFG))
    jsolver.solve_slam()
    ts, _ = reverse_traversal_problem(3, device="cpu")
    tsolver = TSolver(ts, cfg)
    tsolver.solve_slam()
    kw = dict(apply=False, verbose=False)
    jopen = jauto.solve_auto_lc(jsolver, csm_params=JParams(
        scan_range=10.0, high_res=0.05), **kw)
    jrep = jauto.solve_auto_lc(jsolver, use_descriptor_gate=True,
                               csm_params=JParams(scan_range=10.0,
                                                  high_res=0.05), **kw)
    trep = tauto.solve_auto_lc(tsolver, use_descriptor_gate=True,
                               csm_params=CSMParams(scan_range=10.0,
                                                    high_res=0.05), **kw)
    assert trep.gated_pairs == jrep.gated_pairs
    assert trep.accepted == jrep.accepted
    assert set(jrep.gated_pairs) <= set(jopen.gated_pairs)
    assert not trep.applied and not ts.lc_factors
    pictures = sorted(p.name for p in debug.glob("lc_*.png"))
    assert len(pictures) == len(trep.csm_results) > 0
    s, t = trep.csm_results[0][:2]
    assert f"lc_{s:04d}_{t:04d}.png" in pictures
