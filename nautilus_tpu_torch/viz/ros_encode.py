"""ROS wire format for the visualization and command messages, without ROS
(port of nautilus_tpu/viz/ros_encode.py; the same bytes for the same
inputs).

- PointCloud2 field layout and packed x/y/z float32 payload;
- PoseArray (yaw as a z-axis quaternion);
- visualization_msgs/Marker LINE_LIST (the correspondence lines and the
  line map's /debug_lines marker);
- PoseWithCovarianceStamped;
- raw-buffer codecs for the subscribed command topics (HitlSlamInputMsg =
  4x geometry_msgs/Point32, WriteMsg = bool), so the live bridge subscribes
  with rospy.AnyMsg and needs no generated message classes.

Pure functions over plain dicts and bytes; viz/visualizer.py and
viz/bridge.py copy them into rospy messages.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

POINT_STEP = 12  # x, y, z float32


def pointcloud2_fields() -> List[Dict]:
    """The x/y/z float32 field table (pointcloud_helpers.cc:52-65)."""
    return [dict(name=n, offset=4 * i, datatype=7, count=1)
            for i, n in enumerate(("x", "y", "z"))]


def encode_pointcloud2(points: np.ndarray, frame_id: str = "map") -> Dict:
    """Pack 2D points into a PointCloud2-shaped dict (z = 0).

    Returns the message fields as plain Python values; a ROS bridge copies
    them into a sensor_msgs/PointCloud2.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    xyz = np.zeros((len(pts), 3), dtype="<f4")
    xyz[:, :2] = pts
    return dict(
        frame_id=frame_id,
        height=1,
        width=len(pts),
        fields=pointcloud2_fields(),
        is_bigendian=False,
        point_step=POINT_STEP,
        row_step=POINT_STEP * len(pts),
        is_dense=True,
        data=xyz.tobytes(),
    )


def decode_pointcloud2(msg: Dict) -> np.ndarray:
    """Inverse of encode_pointcloud2 (for tests/round-trips)."""
    xyz = np.frombuffer(msg["data"], dtype="<f4").reshape(-1, 3)
    return xyz[:, :2].copy()


def encode_pose_array(poses: np.ndarray, frame_id: str = "map") -> Dict:
    """[N, 3] (x, y, theta) -> PoseArray-shaped dict (solver_vis_ros.cc:80-102:
    yaw encoded as a z-axis quaternion)."""
    poses = np.asarray(poses, np.float64).reshape(-1, 3)
    return dict(
        frame_id=frame_id,
        poses=[dict(x=float(p[0]), y=float(p[1]),
                    qz=float(np.sin(p[2] / 2)), qw=float(np.cos(p[2] / 2)))
               for p in poses])


MARKER_LINE_LIST = 5     # visualization_msgs/Marker::LINE_LIST
MARKER_ADD = 0           # visualization_msgs/Marker::ADD

COLOR_GREEN = (0.0, 1.0, 0.0, 1.0)   # gui_helpers Color4f::kGreen
COLOR_WHITE = (1.0, 1.0, 1.0, 1.0)   # gui_helpers Color4f::kWhite


def encode_marker_line_list(starts, ends, color=COLOR_GREEN,
                            scale: float = 0.05, marker_id: int = 0,
                            frame_id: str = "map") -> Dict:
    """Paired segment endpoints -> Marker LINE_LIST dict.

    Mirrors gui_helpers::InitializeMarker (identity pose, scale.x only,
    frame "map", one rgba per point as AddLine appends,
    gui_helpers.cc:41-78).  ``starts``/``ends``: [N, 2] arrays; point k of
    the marker alternates start_k, end_k with z = 0, exactly the layout
    DrawCorrespondence (solver_vis_ros.cc:140-164) and the vectorize
    /debug_lines marker (solver.cc:593-604) build.
    """
    starts = np.asarray(starts, np.float64).reshape(-1, 2)
    ends = np.asarray(ends, np.float64).reshape(-1, 2)
    if starts.shape != ends.shape:
        raise ValueError("starts/ends must pair up")
    pts = np.zeros((2 * len(starts), 3))
    pts[0::2, :2] = starts
    pts[1::2, :2] = ends
    rgba = dict(r=color[0], g=color[1], b=color[2], a=color[3])
    return dict(
        frame_id=frame_id, id=marker_id, type=MARKER_LINE_LIST,
        action=MARKER_ADD,
        pose=dict(x=0.0, y=0.0, z=0.0, qx=0.0, qy=0.0, qz=0.0, qw=1.0),
        scale_x=float(scale), scale_y=0.0, scale_z=0.0,
        color=rgba,
        points=[dict(x=float(p[0]), y=float(p[1]), z=0.0) for p in pts],
        colors=[dict(rgba) for _ in range(len(pts))])


def encode_pose_with_covariance(pose, cov2x2, seq: int = 0,
                                frame_id: str = "map") -> Dict:
    """(x, y, theta) + 2x2 xy-covariance -> PoseWithCovarianceStamped dict.

    The reference fills row-major 6x6 entries [0], [1], [6], [7]
    (solver_vis_ros.cc:186-194) but writes cov(0,1) into slot [7], which is
    the (1,1) variance — KNOWN FIX (DEVIATIONS.md): we store cov(1,1)
    there so rviz displays the correct y-variance ellipse.
    """
    pose = np.asarray(pose, np.float64).reshape(3)
    cov2x2 = np.asarray(cov2x2, np.float64)[:2, :2]
    cov = np.zeros(36)
    cov[0] = cov2x2[0, 0]
    cov[1] = cov2x2[0, 1]
    cov[6] = cov2x2[1, 0]
    cov[7] = cov2x2[1, 1]
    return dict(
        frame_id=frame_id, seq=int(seq),
        pose=dict(x=float(pose[0]), y=float(pose[1]),
                  qz=float(np.sin(pose[2] / 2)),
                  qw=float(np.cos(pose[2] / 2))),
        covariance=cov.tolist())


# ---------------------------------------------------------------------------
# Raw-buffer codecs for the subscribed command topics (main.cc:204-209)
# ---------------------------------------------------------------------------

def encode_hitl_input(a0, a1, b0, b1) -> bytes:
    """Serialize a HitlSlamInputMsg body: 4x geometry_msgs/Point32
    (float32 x y z, little-endian), in declaration order
    (msg/HitlSlamInputMsg.msg)."""
    out = b""
    for p in (a0, a1, b0, b1):
        p = np.asarray(p, np.float64).reshape(-1)
        z = float(p[2]) if len(p) > 2 else 0.0
        out += struct.pack("<3f", float(p[0]), float(p[1]), z)
    return out


def decode_hitl_input(buff: bytes):
    """Inverse of encode_hitl_input -> 4x np.float64[2] (x, y)."""
    if len(buff) < 48:
        raise ValueError(f"HitlSlamInputMsg needs 48 bytes, got {len(buff)}")
    vals = struct.unpack("<12f", buff[:48])
    return tuple(np.array([vals[3 * i], vals[3 * i + 1]], np.float64)
                 for i in range(4))


def encode_write_msg(write: bool = True) -> bytes:
    """Serialize a WriteMsg body (single bool, msg/WriteMsg.msg)."""
    return struct.pack("<?", bool(write))


def decode_write_msg(buff: bytes) -> bool:
    if len(buff) < 1:
        raise ValueError("WriteMsg needs 1 byte")
    return bool(buff[0])
