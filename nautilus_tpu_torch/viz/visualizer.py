"""Visualization backends for solver progress (port of
nautilus_tpu/viz/visualizer.py).

The reference publishes seven rviz topics (/nautilus/{all_points,
all_poses, edge_points, planar_points, correspondences, auto_lc_scans,
covariances}).  The solver draws once per window (and after every LM step
with ``per_iteration_viz``):

- ``SolverVisualizer``: the interface the solver and auto-LC call;
- ``SnapshotVisualizer``: records pose and cloud snapshots in memory and,
  optionally, as npz files;
- ``MatplotlibVisualizer``: renders the map to a PNG per draw (matplotlib
  is imported on first draw);
- ``RosBridgeVisualizer``: publishes the topics through rospy when rospy
  and the message packages import (``available`` says whether they did).

Tensors come to the host only here: a solve without a visualizer copies
nothing for it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _clouds_in_world(points, mask, solution, nodes) -> np.ndarray:
    """The masked clouds of ``nodes`` moved to the world frame by the
    solution, concatenated [M, 2]."""
    out = []
    for i in nodes:
        p = points[i][mask[i]]
        th = solution[i, 2]
        c, s = np.cos(th), np.sin(th)
        out.append(p @ np.array([[c, s], [-s, c]]) + solution[i, :2])
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2))


def transformed_clouds(state, subset: str = "all") -> np.ndarray:
    """All clouds of ``subset`` ("all", "planar" or "edge") in the world
    frame at the current solution, concatenated [M, 2]."""
    problem = state.problem
    if subset == "all":
        pts, mask = problem.points, problem.points_mask
    elif subset == "planar":
        pts, mask = problem.planar_points, problem.planar_mask
    elif subset == "edge":
        pts, mask = problem.edge_points, problem.edge_mask
    else:
        raise ValueError(subset)
    return _clouds_in_world(_host(pts).astype(np.float64), _host(mask),
                            state.solution, range(state.num_nodes))


class SolverVisualizer:
    """The visualizer interface: every draw is optional."""

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        pass

    def draw_correspondence(self, correspondences) -> None:
        pass

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        pass

    def draw_covariances(self, covariances) -> None:
        pass


@dataclasses.dataclass
class Snapshot:
    window: Optional[int]
    poses: np.ndarray
    all_points: Optional[np.ndarray] = None
    planar_points: Optional[np.ndarray] = None
    edge_points: Optional[np.ndarray] = None


class SnapshotVisualizer(SolverVisualizer):
    """Records each draw; optionally writes snapshots as npz files."""

    def __init__(self, output_dir=None, record_clouds: bool = True):
        self.output_dir = Path(output_dir) if output_dir else None
        self.record_clouds = record_clouds
        self.snapshots: List[Snapshot] = []
        self.lc_scans: List[List[int]] = []
        self.covariances: list = []
        self.correspondences: list = []
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)

    def draw_correspondence(self, correspondences) -> None:
        """Record the masked (source, target) point pairs with their node
        indices, in the sensor frames (the /nautilus/correspondences
        content)."""
        mask = _host(correspondences.mask)
        if mask.size == 0:
            return
        q, s = np.nonzero(mask)
        self.correspondences.append(dict(
            src_node=_host(correspondences.src)[q],
            tgt_node=_host(correspondences.tgt)[q],
            src_pts=_host(correspondences.src_pts)[q, s],
            tgt_pts=_host(correspondences.tgt_pts)[q, s]))

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        snap = Snapshot(window=window, poses=state.solution.copy())
        if self.record_clouds:
            snap.all_points = transformed_clouds(state, "all")
            snap.planar_points = transformed_clouds(state, "planar")
            snap.edge_points = transformed_clouds(state, "edge")
        self.snapshots.append(snap)
        if self.output_dir:
            idx = len(self.snapshots) - 1
            np.savez_compressed(
                self.output_dir / f"snapshot_{idx:04d}.npz",
                window=-1 if window is None else window,
                poses=snap.poses,
                **{k: v for k, v in (("all_points", snap.all_points),
                                     ("planar_points", snap.planar_points),
                                     ("edge_points", snap.edge_points))
                   if v is not None})

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        self.lc_scans.append(list(scan_indices))

    def draw_covariances(self, covariances) -> None:
        self.covariances.append(covariances)


class MatplotlibVisualizer(SolverVisualizer):
    """Renders the current map to map_<count>_<init|w<window>>.png on each
    draw."""

    def __init__(self, output_dir, dpi: int = 120):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.dpi = dpi
        self.count = 0

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        cloud = transformed_clouds(state, "all")
        fig, ax = plt.subplots(figsize=(8, 8))
        if len(cloud):
            ax.plot(cloud[:, 0], cloud[:, 1], ".", ms=0.5, color="#333333")
        ax.plot(state.solution[:, 0], state.solution[:, 1], "-", lw=0.8,
                color="tab:red")
        ax.set_aspect("equal")
        tag = "init" if window is None else f"w{window}"
        ax.set_title(f"nautilus_tpu_torch map ({tag})")
        fig.savefig(self.output_dir / f"map_{self.count:04d}_{tag}.png",
                    dpi=self.dpi, bbox_inches="tight")
        plt.close(fig)
        self.count += 1


def correspondence_world_endpoints(state, correspondences):
    """The masked match endpoints in the world frame at the current
    solution: (starts [M, 2], ends [M, 2]), the /nautilus/correspondences
    LINE_LIST's content."""
    mask = _host(correspondences.mask)
    if mask.size == 0 or not mask.any():
        return np.zeros((0, 2)), np.zeros((0, 2))
    q, s = np.nonzero(mask)
    src_n = _host(correspondences.src)[q]
    tgt_n = _host(correspondences.tgt)[q]
    src_p = _host(correspondences.src_pts).astype(np.float64)[q, s]
    tgt_p = _host(correspondences.tgt_pts).astype(np.float64)[q, s]
    sol = state.solution

    def to_world(nodes, pts):
        th = sol[nodes, 2]
        c, sn = np.cos(th), np.sin(th)
        x = c * pts[:, 0] - sn * pts[:, 1] + sol[nodes, 0]
        y = sn * pts[:, 0] + c * pts[:, 1] + sol[nodes, 1]
        return np.stack([x, y], axis=1)

    return to_world(src_n, src_p), to_world(tgt_n, tgt_p)


class RosBridgeVisualizer(SolverVisualizer):
    """Publishes the seven topics under ``topic_prefix`` through rospy, and
    the line map's white LINE_LIST on /debug_lines.  Without rospy or the
    message packages ``available`` is False and every draw does nothing."""

    def __init__(self, topic_prefix: str = "/nautilus"):
        self.topic_prefix = topic_prefix
        self._pubs = {}
        self._marker_id = 0
        self._cov_seq = 0
        self._last_state = None
        try:
            import rospy
            from geometry_msgs.msg import (PoseArray,
                                           PoseWithCovarianceStamped)
            from sensor_msgs.msg import PointCloud2
            from visualization_msgs.msg import Marker
        except ImportError:
            self._available = False
            return
        self._available = True
        # Publishers are made once: one made per call would be collected
        # before its subscribers' handshakes complete.
        self._pubs["all_poses"] = rospy.Publisher(
            f"{topic_prefix}/all_poses", PoseArray, queue_size=1, latch=True)
        for topic in ("all_points", "planar_points", "edge_points",
                      "auto_lc_scans"):
            self._pubs[topic] = rospy.Publisher(
                f"{topic_prefix}/{topic}", PointCloud2, queue_size=1,
                latch=True)
        self._pubs["correspondences"] = rospy.Publisher(
            f"{topic_prefix}/correspondences", Marker, queue_size=10)
        self._pubs["covariances"] = rospy.Publisher(
            f"{topic_prefix}/covariances", PoseWithCovarianceStamped,
            queue_size=10)
        self._pubs["debug_lines"] = rospy.Publisher(
            "/debug_lines", Marker, queue_size=1, latch=True)

    @property
    def available(self) -> bool:
        return self._available

    # -- dict -> rospy message copies ---------------------------------------

    def _publish_cloud(self, topic: str, points) -> None:
        from sensor_msgs.msg import PointCloud2, PointField
        from nautilus_tpu_torch.viz.ros_encode import encode_pointcloud2
        enc = encode_pointcloud2(points)
        pc = PointCloud2()
        pc.header.frame_id = enc["frame_id"]
        pc.height = enc["height"]
        pc.width = enc["width"]
        pc.fields = [PointField(name=f["name"], offset=f["offset"],
                                datatype=f["datatype"], count=f["count"])
                     for f in enc["fields"]]
        pc.is_bigendian = enc["is_bigendian"]
        pc.point_step = enc["point_step"]
        pc.row_step = enc["row_step"]
        pc.is_dense = enc["is_dense"]
        pc.data = enc["data"]
        self._pubs[topic].publish(pc)

    def _publish_marker(self, topic: str, enc: dict) -> None:
        from geometry_msgs.msg import Point
        from std_msgs.msg import ColorRGBA
        from visualization_msgs.msg import Marker
        m = Marker()
        m.header.frame_id = enc["frame_id"]
        m.id = enc["id"]
        m.type = enc["type"]
        m.action = enc["action"]
        m.pose.orientation.w = enc["pose"]["qw"]
        m.scale.x = enc["scale_x"]
        m.color = ColorRGBA(**enc["color"])
        m.points = [Point(**p) for p in enc["points"]]
        m.colors = [ColorRGBA(**c) for c in enc["colors"]]
        self._pubs[topic].publish(m)

    # -- the seven topics ----------------------------------------------------

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        if not self._available:
            return
        self._last_state = state
        from geometry_msgs.msg import Pose, PoseArray
        from nautilus_tpu_torch.viz.ros_encode import encode_pose_array
        enc = encode_pose_array(state.solution)
        msg = PoseArray()
        msg.header.frame_id = enc["frame_id"]
        for d in enc["poses"]:
            p = Pose()
            p.position.x, p.position.y = d["x"], d["y"]
            p.orientation.z, p.orientation.w = d["qz"], d["qw"]
            msg.poses.append(p)
        self._pubs["all_poses"].publish(msg)
        for subset, topic in (("all", "all_points"),
                              ("planar", "planar_points"),
                              ("edge", "edge_points")):
            self._publish_cloud(topic, transformed_clouds(state, subset))

    def draw_correspondence(self, correspondences) -> None:
        if not self._available or self._last_state is None:
            return
        from nautilus_tpu_torch.viz.ros_encode import encode_marker_line_list
        starts, ends = correspondence_world_endpoints(
            self._last_state, correspondences)
        if not len(starts):
            return      # the reference publishes no empty correspondences
        enc = encode_marker_line_list(starts, ends,
                                      marker_id=self._marker_id)
        self._marker_id += 1
        self._publish_marker("correspondences", enc)

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        if not self._available:
            return
        problem = state.problem
        cloud = _clouds_in_world(_host(problem.points).astype(np.float64),
                                 _host(problem.points_mask), state.solution,
                                 scan_indices)
        self._publish_cloud("auto_lc_scans", cloud)

    def draw_covariances(self, covariances) -> None:
        """covariances: [(node_idx, cov)] pairs, published one
        PoseWithCovarianceStamped each."""
        if not self._available or self._last_state is None:
            return
        from geometry_msgs.msg import PoseWithCovarianceStamped
        from nautilus_tpu_torch.viz.ros_encode import \
            encode_pose_with_covariance
        for node_idx, cov in covariances:
            enc = encode_pose_with_covariance(
                self._last_state.solution[node_idx], cov, seq=self._cov_seq)
            self._cov_seq += 1
            msg = PoseWithCovarianceStamped()
            msg.header.frame_id = enc["frame_id"]
            msg.header.seq = enc["seq"]
            msg.pose.pose.position.x = enc["pose"]["x"]
            msg.pose.pose.position.y = enc["pose"]["y"]
            msg.pose.pose.orientation.z = enc["pose"]["qz"]
            msg.pose.pose.orientation.w = enc["pose"]["qw"]
            msg.pose.covariance = enc["covariance"]
            self._pubs["covariances"].publish(msg)

    def publish_debug_lines(self, segments) -> None:
        """The line map as a white LINE_LIST on /debug_lines."""
        if not self._available or not segments:
            return
        from nautilus_tpu_torch.viz.ros_encode import (COLOR_WHITE,
                                                       encode_marker_line_list)
        starts = np.asarray([s for s, _ in segments])
        ends = np.asarray([e for _, e in segments])
        enc = encode_marker_line_list(starts, ends, color=COLOR_WHITE,
                                      marker_id=self._marker_id)
        self._marker_id += 1
        self._publish_marker("debug_lines", enc)
