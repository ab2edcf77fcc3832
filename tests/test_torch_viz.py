"""PyTorch port: the ROS wire encoders, the visualizers and the solver's and
auto-LC's draw hooks against the JAX package.

Encoders are compared for equal dicts and bytes.  World-frame clouds and
correspondence endpoints agree within 1e-5 m (float32 clouds moved in
float64 on both sides).  Snapshots follow the JAX package's draw points;
their poses agree within 5e-4 m, the spread of the JAX package's own two
sweeps (LM stops on float32 noise once converged).
"""

import sys

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text as jload
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.kernels.csm import CSMParams as JParams
from nautilus_tpu.loop_closure import auto_lc as jauto
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu.viz import ros_encode as jenc
from nautilus_tpu.viz import visualizer as jviz
from nautilus_tpu_torch.core.luaconf import load_config_text as tload
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.kernels.csm import CSMParams as TParams
from nautilus_tpu_torch.loop_closure import auto_lc as tauto
from nautilus_tpu_torch.solve.solver import Solver as TSolver
from nautilus_tpu_torch.viz import ros_encode as tenc
from nautilus_tpu_torch.viz import visualizer as tviz

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n")
POSE_ATOL = 5e-4


def _pair(num_nodes=24, world="office", num_beams=180, seed=0, **kw):
    js, _ = make_problem(num_nodes, world, num_beams=num_beams, seed=seed,
                         **kw)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    return js, ts


@pytest.fixture(scope="module")
def office():
    return _pair(odom_noise_trans=0.02, odom_noise_rot=0.008)


def _copy(ts):
    """A fresh port state on ``ts``'s problem and solution."""
    return SLAMState(problem=ts.problem, solution=ts.solution.copy(),
                     timestamps=ts.timestamps,
                     odometry_factors=ts.odometry_factors,
                     initial_odometry_factors=ts.initial_odometry_factors)


# -- wire encoders -------------------------------------------------------------

def _cases(rng):
    pts = rng.normal(size=(57, 2)).astype(np.float32)
    poses = rng.normal(size=(5, 3))
    starts, ends = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
    cov = np.array([[4.0, 0.5], [0.5, 9.0]])
    return [
        ("pointcloud2", (pts,), {}),
        ("pointcloud2", (pts[:0],), {"frame_id": "odom"}),
        ("pose_array", (poses,), {}),
        ("marker_line_list", (starts, ends), {}),
        ("marker_line_list", (starts, ends),
         {"color": jenc.COLOR_WHITE, "scale": 0.1, "marker_id": 7}),
        ("pose_with_covariance", (poses[0], cov), {"seq": 3}),
        ("hitl_input", ((-1.0, 2.0), (3.5, 2.0), (-1.0, 2.5),
                        (3.5, 2.6, 0.25)), {}),
        ("write_msg", (True,), {}),
        ("write_msg", (False,), {}),
    ]


def test_every_encoder_gives_the_jax_packages_output(rng):
    for name, args, kw in _cases(rng):
        got = getattr(tenc, f"encode_{name}")(*args, **kw)
        want = getattr(jenc, f"encode_{name}")(*args, **kw)
        assert type(got) is type(want), name
        assert got == want, name
    assert tenc.pointcloud2_fields() == jenc.pointcloud2_fields()
    for const in ("POINT_STEP", "MARKER_LINE_LIST", "MARKER_ADD",
                  "COLOR_GREEN", "COLOR_WHITE"):
        assert getattr(tenc, const) == getattr(jenc, const)


def test_decoders_round_trip_and_read_the_jax_bytes(rng):
    pts = rng.normal(size=(31, 2)).astype(np.float32)
    for enc in (tenc.encode_pointcloud2(pts), jenc.encode_pointcloud2(pts)):
        np.testing.assert_array_equal(tenc.decode_pointcloud2(enc), pts)
    lines = ((-1.0, 2.0), (3.5, 2.0), (-1.0, 2.5), (3.5, 2.6))
    buff = jenc.encode_hitl_input(*lines)
    assert len(buff) == 48
    for got, want in zip(tenc.decode_hitl_input(buff), lines):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for got, want in zip(tenc.decode_hitl_input(buff),
                         jenc.decode_hitl_input(buff)):
        np.testing.assert_array_equal(got, want)
    assert tenc.decode_write_msg(jenc.encode_write_msg(True)) is True
    assert tenc.decode_write_msg(tenc.encode_write_msg(False)) is False
    with pytest.raises(ValueError):
        tenc.decode_hitl_input(b"\x00" * 12)
    with pytest.raises(ValueError):
        tenc.decode_write_msg(b"")


# -- clouds and endpoints ------------------------------------------------------

@pytest.mark.parametrize("subset", ["all", "planar", "edge"])
def test_transformed_clouds_match_jax(office, subset):
    js, ts = office
    got = tviz.transformed_clouds(ts, subset)
    want = jviz.transformed_clouds(js, subset)
    assert got.shape == want.shape and got.shape[1] == 2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tviz.transformed_clouds(ts, "walls")


def test_correspondence_world_endpoints_match_jax(office):
    js, ts = office
    jsol, tsol = JSolver(js, jload(CFG)), TSolver(ts, tload(CFG))
    jg = jsol.build_graph(jsol._current_x(), 3)
    tg = tsol.build_graph(tsol._current_x(), 3)
    for feature in ("planar", "edge"):
        ws, we = jviz.correspondence_world_endpoints(js, getattr(jg, feature))
        gs, ge = tviz.correspondence_world_endpoints(ts, getattr(tg, feature))
        assert len(gs) == len(ws) > 0
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
        np.testing.assert_allclose(ge, we, atol=1e-5, rtol=0)
    d = np.linalg.norm(gs - ge, axis=1)
    assert float(np.median(d)) < 0.5


# -- the solver's draw points ------------------------------------------------

def _snapshots(js, ts, cfg_text, per_iteration_viz=False, record=True):
    jvis = jviz.SnapshotVisualizer(record_clouds=record)
    tvis = tviz.SnapshotVisualizer(record_clouds=record)
    jstats = JSolver(js, jload(cfg_text), visualizer=jvis,
                     per_iteration_viz=per_iteration_viz).solve_slam()
    tstats = TSolver(ts, tload(cfg_text), visualizer=tvis,
                     per_iteration_viz=per_iteration_viz).solve_slam()
    return jvis, tvis, jstats, tstats


def test_snapshots_per_window_match_jax():
    js, ts = _pair(odom_noise_trans=0.02, odom_noise_rot=0.008)
    jvis, tvis, _, tstats = _snapshots(js, ts, CFG)
    # The initial solution, then one per window.
    assert [s.window for s in tvis.snapshots] == \
        [s.window for s in jvis.snapshots] == [None, 1, 2, 3]
    np.testing.assert_array_equal(tvis.snapshots[0].poses,
                                  jvis.snapshots[0].poses)
    for got, want in zip(tvis.snapshots[1:], jvis.snapshots[1:]):
        np.testing.assert_allclose(got.poses, want.poses, atol=POSE_ATOL,
                                   rtol=0)
        assert got.all_points.shape == want.all_points.shape
        assert len(got.planar_points) == len(want.planar_points)
        assert len(got.edge_points) == len(want.edge_points)
    np.testing.assert_array_equal(tvis.snapshots[-1].poses, ts.solution)
    # Planar and edge correspondences of each window.
    assert len(tvis.correspondences) == len(jvis.correspondences) == 6
    for got, want in zip(tvis.correspondences, jvis.correspondences):
        assert got["src_pts"].shape == got["tgt_pts"].shape
        assert len(got["src_node"]) == len(got["src_pts"])
        assert abs(len(got["src_pts"]) - len(want["src_pts"])) <= \
            0.02 * len(want["src_pts"])
    assert [w.window for w in tstats.windows] == [1, 2, 3]


def test_per_iteration_viz_matches_jax():
    js, ts = _pair(8, "room", seed=7, odom_noise_trans=0.02,
                   odom_noise_rot=0.01)
    text = CFG.replace("amount_max=3", "amount_max=2")
    jvis, tvis, jstats, tstats = _snapshots(js, ts, text, True, False)
    for vis, stats in ((jvis, jstats), (tvis, tstats)):
        iters = sum(w.iterations for w in stats.windows)
        # The initial draw, one per LM step, one per window.
        assert len(vis.snapshots) == 1 + len(stats.windows) + iters
        assert iters > len(stats.windows)
    assert tvis.snapshots[-1].all_points is None
    np.testing.assert_allclose(tvis.snapshots[-1].poses,
                               jvis.snapshots[-1].poses, atol=POSE_ATOL,
                               rtol=0)
    for jw, tw in zip(jstats.windows, tstats.windows):
        np.testing.assert_allclose(tw.final_cost, jw.final_cost, rtol=1e-4)
    # The steps of window 1, each drawn with its window.
    first = [s.window for s in tvis.snapshots[1:tstats.windows[0]
                                              .iterations + 2]]
    assert first == [1] * (tstats.windows[0].iterations + 1)


def test_without_a_visualizer_per_iteration_viz_changes_nothing(office):
    a, b = _copy(office[1]), _copy(office[1])
    sa = TSolver(a, tload(CFG)).solve_slam()
    solver = TSolver(b, tload(CFG), per_iteration_viz=True)
    assert not solver.per_iteration_viz
    sb = solver.solve_slam()
    assert solver.last_solver == "band"
    np.testing.assert_array_equal(a.solution, b.solution)
    assert [w.final_cost for w in sa.windows] == \
        [w.final_cost for w in sb.windows]


def test_max_window_draws_its_solution_once(office):
    vis = tviz.SnapshotVisualizer(record_clouds=False)
    TSolver(_copy(office[1]), tload(CFG), visualizer=vis).solve_max_window()
    assert [s.window for s in vis.snapshots] == [3]
    assert not vis.correspondences


def test_auto_lc_draws_the_jax_packages_scans_and_covariances():
    cfg = CFG + ("lc_translation_weight=1\nlc_rotation_weight=1\n"
                 "csm_score_threshold=-5.0\nmax_lidar_range=10\n")
    js, ts = _pair(20, "building", num_beams=360, seed=8)
    jvis = jviz.SnapshotVisualizer(record_clouds=False)
    tvis = tviz.SnapshotVisualizer(record_clouds=False)
    jsolver = JSolver(js, jload(cfg), visualizer=jvis)
    tsolver = TSolver(ts, tload(cfg), visualizer=tvis)
    jsolver.solve_slam()
    tsolver.solve_slam()
    jrep = jauto.solve_auto_lc(jsolver, apply=False, verbose=False,
                               csm_params=JParams(scan_range=10.0,
                                                  high_res=0.05))
    trep = tauto.solve_auto_lc(tsolver, apply=False, verbose=False,
                               csm_params=TParams(scan_range=10.0,
                                                  high_res=0.05))
    assert tvis.lc_scans == jvis.lc_scans == [trep.candidates]
    assert trep.candidates == jrep.candidates
    assert trep.gated_pairs == jrep.gated_pairs
    assert len(tvis.covariances) == len(jvis.covariances) == \
        (1 if trep.gated_pairs else 0)
    for got, want in zip(tvis.covariances, jvis.covariances):
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, gc), (_, wc) in zip(got, want):
            np.testing.assert_allclose(gc, np.asarray(wc), rtol=2e-3,
                                       atol=2e-3 * np.abs(wc).max())


# -- files ---------------------------------------------------------------------

def test_snapshot_npz_output(office, tmp_path):
    _, ts = office
    vis = tviz.SnapshotVisualizer(output_dir=tmp_path)
    vis.draw_solution(ts)
    vis.draw_solution(ts, window=2)
    files = sorted(tmp_path.glob("snapshot_*.npz"))
    assert [f.name for f in files] == ["snapshot_0000.npz",
                                       "snapshot_0001.npz"]
    z = np.load(files[1])
    assert int(z["window"]) == 2 and z["poses"].shape == (24, 3)
    np.testing.assert_array_equal(z["all_points"],
                                  tviz.transformed_clouds(ts, "all"))
    assert int(np.load(files[0])["window"]) == -1


def test_matplotlib_visualizer_writes_a_png(office, tmp_path):
    pytest.importorskip("matplotlib")
    _, ts = office
    vis = tviz.MatplotlibVisualizer(tmp_path / "maps")
    vis.draw_solution(ts)
    vis.draw_solution(ts, window=3)
    names = sorted(p.name for p in (tmp_path / "maps").glob("*.png"))
    assert names == ["map_0000_init.png", "map_0001_w3.png"]
    assert (tmp_path / "maps" / names[0]).read_bytes()[:4] == b"\x89PNG"


def test_ros_visualizer_is_unavailable_without_rospy(monkeypatch):
    monkeypatch.setitem(sys.modules, "rospy", None)    # import rospy fails
    vis = tviz.RosBridgeVisualizer()
    assert not vis.available and vis._pubs == {}
    vis.draw_solution(None)
    vis.draw_correspondence(None)
    vis.draw_scans(None, [0])
    vis.draw_covariances([(0, np.eye(2))])
    vis.publish_debug_lines([(np.zeros(2), np.ones(2))])
