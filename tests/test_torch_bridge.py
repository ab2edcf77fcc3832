"""PyTorch port: the live ROS command bridge and ``--ros``, after
tests/test_bridge.py, against the JAX package's bridge.

Both bridges get the same wire-encoded messages.  The HITL step is the
doubled-wall curation case of tests/test_torch_hitl.py; its per-window costs
agree within rtol 1e-4 and its poses within 5e-4 m, that file's bars (LM
stops on float32 noise once converged).  rospy and the ROS message packages
are stubbed in ``sys.modules``: no ROS master is needed.
"""

import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text as jload
from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve.solver import Solver as JSolver
from nautilus_tpu.viz import ros_encode as jenc
from nautilus_tpu.viz.bridge import RosInputBridge as JBridge
from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.core.luaconf import load_config_text as tload
from nautilus_tpu_torch.core.problem import SLAMState, problem_from_numpy
from nautilus_tpu_torch.solve.solver import Solver as TSolver
from nautilus_tpu_torch.viz import ros_encode as tenc
from nautilus_tpu_torch.viz.bridge import RosInputBridge

ROOT = Path(__file__).resolve().parents[1]
CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n"
       "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n"
       'hitl_lc_topic="/hitl_slam_input"\n'
       'pose_output_file="poses_out.txt"\nmap_output_file="map_out.csv"\n')
# Poses 12-23 of the 24-pose office map drift 0.3 m in y, so the y = -2
# wall shows twice: line A on its true place, line B on the copy.
SHIFT = 0.3
LINES = ((2.0, -2.0), (10.0, -2.0), (2.0, -2.0 + SHIFT), (10.0, -2.0 + SHIFT))


def _recording(solver):
    """Record the SolveStats of each solve_slam the solver runs."""
    stats, solve = [], solver.solve_slam

    def solve_and_record(*a, **kw):
        stats.append(solve(*a, **kw))
        return stats[-1]

    solver.solve_slam = solve_and_record
    return stats


@pytest.fixture(scope="module")
def solved():
    js, _ = make_problem(24, "office", num_beams=180, seed=0,
                         odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(js.problem, f))
              for f in js.problem._fields}
    ts = SLAMState.from_problem(problem_from_numpy(arrays, "cpu"),
                                js.timestamps)
    ts.solution = js.solution.copy()
    jsolver, tsolver = JSolver(js, jload(CFG)), TSolver(ts, tload(CFG))
    jsolver.solve_slam()
    tsolver.solve_slam()
    for s in (js, ts):
        s.solution[12:, 1] += SHIFT
    return jsolver, tsolver


def test_hitl_message_adds_the_constraint_and_resolves_as_jax(solved):
    jsolver, tsolver = solved
    buff = tenc.encode_hitl_input(*LINES)
    assert buff == jenc.encode_hitl_input(*LINES)
    jstats, tstats = _recording(jsolver), _recording(tsolver)
    jbridge = JBridge(jsolver, jsolver.config, verbose=False)
    bridge = RosInputBridge(tsolver, tsolver.config, verbose=False)
    jbridge.dispatch("/hitl_slam_input", buff)
    bridge.dispatch("/hitl_slam_input", buff)
    assert bridge.handled == 1
    js, ts = jsolver.state, tsolver.state
    assert len(ts.hitl_constraints) == len(js.hitl_constraints) == 1
    tc, jc = ts.hitl_constraints[0], js.hitl_constraints[0]
    assert [k for k, _ in tc.line_a_poses] == [k for k, _ in jc.line_a_poses]
    assert [k for k, _ in tc.line_b_poses] == [k for k, _ in jc.line_b_poses]
    assert tc.line_a_poses and tc.line_b_poses
    assert len(tstats) == len(jstats) == 2      # solved, then initial odometry
    for jst, tst in zip(jstats, tstats):
        assert [w.window for w in tst.windows] == [1, 2, 3]
        for jw, tw in zip(jst.windows, tst.windows):
            np.testing.assert_allclose(tw.initial_cost, jw.initial_cost,
                                       rtol=1e-4)
            np.testing.assert_allclose(tw.final_cost, jw.final_cost,
                                       rtol=1e-4)
    np.testing.assert_allclose(ts.solution, js.solution, atol=5e-4, rtol=0)
    np.testing.assert_allclose(ts.line_poses, np.asarray(js.line_poses),
                               atol=5e-4, rtol=0)


def test_write_and_vectorize_are_routed(solved, tmp_path, monkeypatch):
    _, tsolver = solved
    monkeypatch.chdir(tmp_path)
    bridge = RosInputBridge(tsolver, tsolver.config, verbose=False)
    bridge.dispatch("/write_output", tenc.encode_write_msg())
    rows = (tmp_path / "poses_out.txt").read_text().strip().splitlines()
    assert len(rows) == tsolver.state.num_nodes
    bridge.dispatch("/vectorize_output", tenc.encode_write_msg(False))
    assert (tmp_path / "map_out.csv").exists()
    assert bridge.handled == 2
    # Callbacks replace the default actions; the vectorized lines go to a
    # visualizer that publishes them.
    seen = []
    bridge = RosInputBridge(tsolver, tsolver.config, verbose=False,
                            on_write=lambda: seen.append("w"),
                            on_vectorize=lambda: seen.append("v"))
    bridge.dispatch("/write_output", tenc.encode_write_msg())
    bridge.dispatch("/vectorize_output", tenc.encode_write_msg())
    assert seen == ["w", "v"] and bridge.handled == 2

    class Lines:
        def publish_debug_lines(self, segments):
            seen.append(len(segments))

    tsolver.visualizer = Lines()
    try:
        RosInputBridge(tsolver, tsolver.config, verbose=False).dispatch(
            "/vectorize_output", tenc.encode_write_msg())
    finally:
        tsolver.visualizer = None
    assert isinstance(seen[-1], int)


def test_unknown_topic_and_short_messages_raise(solved):
    _, tsolver = solved
    bridge = RosInputBridge(tsolver, tsolver.config, verbose=False)
    with pytest.raises(KeyError):
        bridge.dispatch("/nope", b"")
    with pytest.raises(ValueError):
        bridge.dispatch("/hitl_slam_input", b"\x00" * 47)
    with pytest.raises(ValueError):
        bridge.dispatch("/write_output", b"")
    assert bridge.handled == 0


def test_topic_name_comes_from_the_config(solved):
    _, tsolver = solved
    cfg = tload(CFG.replace('"/hitl_slam_input"', '"/custom_hitl"'))
    bridge = RosInputBridge(tsolver, cfg, verbose=False)
    jbridge = JBridge(None, jload(CFG.replace('"/hitl_slam_input"',
                                              '"/custom_hitl"')))
    assert list(bridge.topics()) == list(jbridge.topics()) == \
        ["/custom_hitl", "/write_output", "/vectorize_output"]
    assert RosInputBridge(tsolver, tload("x=1\n")).hitl_topic == \
        "/hitl_slam_input"


class _Msg:
    """A message stub: attributes spring into being on first read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = _Msg()
        setattr(self, name, value)
        return value


def _stub_ros(monkeypatch):
    """rospy and the message packages as stubs recording what is done."""
    log = {"init": [], "subs": [], "unregistered": 0, "spins": 0,
           "published": []}
    rospy = types.ModuleType("rospy")
    rospy.core = types.SimpleNamespace(get_node_uri=lambda: None)
    rospy.AnyMsg = object()
    rospy.init_node = lambda name, **kw: log["init"].append((name, kw))

    class Subscriber:
        def __init__(self, topic, kind, callback, queue_size):
            log["subs"].append((topic, kind, callback, queue_size))

        def unregister(self):
            log["unregistered"] += 1

    class Publisher:
        def __init__(self, topic, kind, **kw):
            self.topic = topic

        def publish(self, msg):
            log["published"].append(self.topic)

    rospy.Subscriber, rospy.Publisher = Subscriber, Publisher
    rospy.spin = lambda: log.__setitem__("spins", log["spins"] + 1)

    class PoseArray(_Msg):
        def __init__(self, **kw):
            super().__init__(poses=[], **kw)

    packages = {"rospy": rospy}
    for pkg, names in (("geometry_msgs", ("PoseArray", "Pose", "Point",
                                          "PoseWithCovarianceStamped")),
                       ("sensor_msgs", ("PointCloud2", "PointField")),
                       ("visualization_msgs", ("Marker",)),
                       ("std_msgs", ("ColorRGBA",))):
        msg = types.ModuleType(f"{pkg}.msg")
        for name in names:
            setattr(msg, name, PoseArray if name == "PoseArray"
                    else type(name, (_Msg,), {}))
        top = types.ModuleType(pkg)
        top.msg = msg
        packages[pkg], packages[f"{pkg}.msg"] = top, msg
    for name, mod in packages.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return log


def test_start_subscribes_the_three_topics_and_routes_buff(solved,
                                                            monkeypatch):
    _, tsolver = solved
    log = _stub_ros(monkeypatch)
    seen = []
    bridge = RosInputBridge(tsolver, tsolver.config, verbose=False,
                            on_write=lambda: seen.append("write"),
                            on_vectorize=lambda: seen.append("vectorize"))
    bridge.start()
    assert [name for name, _ in log["init"]] == ["nautilus_tpu_torch"]
    assert [s[0] for s in log["subs"]] == ["/hitl_slam_input",
                                           "/write_output",
                                           "/vectorize_output"]
    assert all(s[1] is sys.modules["rospy"].AnyMsg and s[3] == 10
               for s in log["subs"])
    callbacks = {s[0]: s[2] for s in log["subs"]}
    callbacks["/vectorize_output"](types.SimpleNamespace(
        _buff=tenc.encode_write_msg()))
    callbacks["/write_output"](types.SimpleNamespace(
        _buff=tenc.encode_write_msg()))
    assert seen == ["vectorize", "write"] and bridge.handled == 2
    bridge.spin()
    assert log["spins"] == 1
    bridge.stop()
    assert log["unregistered"] == 3 and bridge._subs == []


def _cli_args(tmp_path):
    cfg = tmp_path / "ros.lua"
    shutil.copy(ROOT / "config" / "default_config.lua",
                tmp_path / "default_config.lua")
    cfg.write_text('dofile("default_config.lua")\n'
                   "pose_number=8\nlidar_constraint_amount_max=2\n")
    return ["--config_file", str(cfg), "--synthetic", "room", "--device",
            "cpu", "--quiet", "--ros"]


def test_cli_ros_returns_1_without_rospy(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "rospy", None)   # import rospy fails
    rc, solver, _ = torch_cli.run(_cli_args(tmp_path))
    assert rc == 1 and solver is None
    assert "--ros requested but rospy is not importable." in \
        capsys.readouterr().out


def test_cli_ros_publishes_and_runs_the_bridge(tmp_path, monkeypatch):
    """Where rospy imports, --ros attaches the rviz visualizer to the
    solver, solves, then subscribes the command topics and spins."""
    from nautilus_tpu_torch.viz.visualizer import RosBridgeVisualizer
    log = _stub_ros(monkeypatch)
    rc, solver, walls = torch_cli.run(_cli_args(tmp_path))
    assert rc == 0 and "solve" in walls
    assert isinstance(solver.visualizer, RosBridgeVisualizer)
    assert solver.visualizer.available
    # The initial draw and one per window publish poses and three clouds.
    assert log["published"].count("/nautilus/all_poses") == 3
    assert log["published"].count("/nautilus/all_points") == 3
    assert "/nautilus/correspondences" in log["published"]
    assert [s[0] for s in log["subs"]] == ["/hitl_slam_input",
                                           "/write_output",
                                           "/vectorize_output"]
    assert log["spins"] == 1
