"""Bag streams -> pose-graph arrays: the SLAMTypeBuilder port (port of
nautilus_tpu/ingest/builder.py; host numpy, bitwise equal to it).

Faithful host-side replication of the reference ingest semantics
(src/input/slam_type_builder.{h,cc}):

- Node capture gating: a new node is captured when the pending odometry
  motion since the last capture satisfies ``pending_rotation >=
  rotation_change_for_lidar OR |pending_translation| >=
  translation_change_for_lidar`` (slam_type_builder.h:29-33 — note the
  *signed* rotation comparison; preserved).
- Beam truncation: the first and last 55 beams of each captured scan are
  invalidated before conversion (slam_type_builder.cc:56-65), using the
  reference's computed ``num_ranges = (angle_max - angle_min) /
  angle_increment`` loop bound.
- Polar -> Cartesian conversion with [range_min, max_range] gating
  (reference LaserScanToPointCloud, pointcloud_helpers.cc:28-48).
- Absolute odometry tracking (nav_msgs/Odometry): quaternion -> yaw with
  the reference's exact formula incl. its q.x*q.z term and ==0.5 gimbal
  guards (slam_type_builder.cc:97-109); pending deltas measured against
  the last captured pose; capture rotates the pending translation by
  -init_odom_angle (slam_type_builder.cc:148-182).
- Differential odometry tracking (CobotOdometryMsg): dr/dx/dy
  accumulation with angle_mod, first message initializes only; capture
  rotates pending translation by the accumulated heading
  (slam_type_builder.cc:126-146).
- One odometry factor per consecutive node pair carrying the world-frame
  pose delta (slam_type_builder.cc:31-42); pose cap stops ingest
  (slam_type_builder.cc:184-187).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from nautilus_tpu_torch.core.problem import RawNodes, pad_clouds
from nautilus_tpu_torch.ingest import native
from nautilus_tpu_torch.ingest.rosbag import (CobotOdometryMsg, LaserScanMsg,
                                              OdometryMsg, read_bag)

TRUNCATION_SIZE = 55


def _angle_mod(a: float) -> float:
    return a - 2.0 * np.pi * np.round(a / (2.0 * np.pi))


def z_radians_from_quaternion(q: np.ndarray) -> float:
    """Reference ZRadiansFromQuaterion (slam_type_builder.cc:97-109),
    including its nonstandard q.x*q.z cross term and exact ==+-0.5 guards."""
    x, y, z, w = q
    t = x * y + z * w
    if t == 0.5 or t == -0.5:
        return 0.0
    first = 2.0 * (w * z + x * z)
    second = 1.0 - 2.0 * (y * y + z * z)
    return float(np.arctan2(first, second))


def laser_scan_to_points(scan: LaserScanMsg, max_range: float) -> np.ndarray:
    """Polar -> Cartesian with range gating (pointcloud_helpers.cc:28-48)."""
    idx = np.arange(len(scan.ranges))
    angles = scan.angle_min + scan.angle_increment * idx
    r = np.asarray(scan.ranges, np.float64)
    keep = (r >= scan.range_min) & (r <= max_range)
    r = r[keep]
    th = angles[keep]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1).astype(
        np.float32)


class AbsoluteOdometryTracking:
    """nav_msgs/Odometry integration (slam_type_builder.cc:148-182)."""

    def __init__(self, rotation_change: float, translation_change: float):
        self.rotation_change = rotation_change
        self.translation_change = translation_change
        self.initialized = False
        self.init_trans = np.zeros(2)
        self.init_angle = 0.0
        self.odom_trans = np.zeros(2)
        self.odom_angle = 0.0
        self.pending_trans = np.zeros(2)
        self.pending_rot = 0.0
        self.last_trans = np.zeros(2)
        self.last_angle = 0.0
        self.adj_trans = np.zeros(2)
        self.adj_rot = 0.0

    def callback(self, msg: OdometryMsg):
        if not self.initialized:
            self.init_trans = msg.position[:2].copy()
            self.init_angle = z_radians_from_quaternion(msg.orientation)
            self.last_trans = self.init_trans.copy()
            self.last_angle = self.init_angle
            self.initialized = True
        self.odom_angle = z_radians_from_quaternion(msg.orientation)
        self.pending_rot = self.odom_angle - self.last_angle
        self.odom_trans = msg.position[:2].copy()
        self.pending_trans = self.odom_trans - self.last_trans

    def ready_for_lidar(self) -> bool:
        return (self.pending_rot >= self.rotation_change
                or np.linalg.norm(self.pending_trans)
                >= self.translation_change)

    def reset_inits(self):
        self.init_angle = self.odom_angle
        self.init_trans = self.odom_trans.copy()
        self.pending_trans = np.zeros(2)
        self.pending_rot = 0.0
        self.last_angle = self.init_angle
        self.last_trans = self.init_trans.copy()

    def get_pose(self):
        c, s = np.cos(-self.init_angle), np.sin(-self.init_angle)
        rot = np.array([[c, -s], [s, c]])
        total_trans = self.adj_trans + rot @ self.pending_trans
        total_rot = _angle_mod(self.adj_rot + self.pending_rot)
        self.pending_trans = np.zeros(2)
        self.pending_rot = 0.0
        self.last_angle = self.odom_angle
        self.last_trans = self.odom_trans.copy()
        self.adj_trans = total_trans
        self.adj_rot = total_rot
        return np.array([total_trans[0], total_trans[1], total_rot])


class DifferentialOdometryTracking:
    """CobotOdometryMsg integration (slam_type_builder.cc:126-146)."""

    def __init__(self, rotation_change: float, translation_change: float):
        self.rotation_change = rotation_change
        self.translation_change = translation_change
        self.initialized = False
        self.pending_trans = np.zeros(2)
        self.pending_rot = 0.0
        self.total_trans = np.zeros(2)
        self.total_rot = 0.0

    def callback(self, msg: CobotOdometryMsg):
        if not self.initialized:
            self.initialized = True
            self.pending_rot = 0.0
            self.pending_trans = np.zeros(2)
        else:
            self.pending_rot = _angle_mod(msg.dr + self.pending_rot)
            self.pending_trans = self.pending_trans + np.array([msg.dx, msg.dy])

    def ready_for_lidar(self) -> bool:
        return (self.pending_rot >= self.rotation_change
                or np.linalg.norm(self.pending_trans)
                >= self.translation_change)

    def reset_inits(self):
        self.total_trans = np.zeros(2)
        self.total_rot = 0.0

    def get_pose(self):
        c, s = np.cos(self.total_rot), np.sin(self.total_rot)
        rot = np.array([[c, -s], [s, c]])
        self.total_trans = self.total_trans + rot @ self.pending_trans
        self.total_rot = _angle_mod(self.total_rot + self.pending_rot)
        self.pending_trans = np.zeros(2)
        self.pending_rot = 0.0
        return np.array([self.total_trans[0], self.total_trans[1],
                         self.total_rot])


@dataclasses.dataclass
class CapturedNode:
    pose: np.ndarray       # [3] odometry-derived initial pose
    points: np.ndarray     # [k, 2] sensor-frame cloud
    timestamp: float


class SLAMTypeBuilder:
    """Streaming node capture (reference SLAMTypeBuilder,
    slam_type_builder.h:85-103)."""

    def __init__(self, config):
        self.config = config
        self.diff_odom = bool(config.differential_odom)
        rc = float(config.rotation_change_for_lidar)
        tc = float(config.translation_change_for_lidar)
        self.abs_tracking = AbsoluteOdometryTracking(rc, tc)
        self.diff_tracking = DifferentialOdometryTracking(rc, tc)
        self.max_pose_num = config.get_int("pose_number")
        self.nodes: List[CapturedNode] = []
        self.odom_factors: List[tuple] = []

    def done(self) -> bool:
        return len(self.nodes) >= self.max_pose_num

    def _tracking(self):
        return self.diff_tracking if self.diff_odom else self.abs_tracking

    def lidar_callback(self, scan: LaserScanMsg):
        if not (self._tracking().ready_for_lidar() and not self.done()):
            return
        cfg_range = float(self.config.max_lidar_range)
        max_range = scan.range_max if cfg_range <= 0 else cfg_range
        # Beam truncation (slam_type_builder.cc:56-65): invalidate the first
        # and last 55 beams using the reference's computed num_ranges bound.
        ranges = np.asarray(scan.ranges, np.float64).copy()
        num_ranges = int((scan.angle_max - scan.angle_min)
                         / scan.angle_increment)
        idx = np.arange(len(ranges))
        trunc = (idx < TRUNCATION_SIZE) | (idx > num_ranges - TRUNCATION_SIZE)
        ranges[trunc] = max_range + 1.0
        scan = dataclasses.replace(scan, ranges=ranges)
        points = laser_scan_to_points(scan, max_range)
        if len(self.nodes) == 0:
            self._tracking().reset_inits()
        pose = self._tracking().get_pose()
        self.nodes.append(CapturedNode(pose=pose, points=points,
                                       timestamp=scan.header.stamp))
        if len(self.nodes) > 1:
            prev = self.nodes[-2].pose
            self.odom_factors.append(
                (len(self.nodes) - 2, len(self.nodes) - 1,
                 pose[:2] - prev[:2], pose[2] - prev[2]))

    def odometry_callback(self, msg):
        if isinstance(msg, OdometryMsg):
            self.abs_tracking.callback(msg)
        elif isinstance(msg, CobotOdometryMsg):
            if not self.diff_odom:
                raise ValueError(
                    "Received Cobot odometry message, but differential "
                    "odometry is not enabled.")
            self.diff_tracking.callback(msg)

    def to_raw_nodes(self, pad_multiple: int = 128) -> RawNodes:
        if len(self.nodes) < 2:
            raise ValueError("Not enough nodes were processed; "
                             "check the configured topics.")
        points, mask = pad_clouds([n.points for n in self.nodes],
                                  pad_multiple=pad_multiple)
        f = self.odom_factors
        return RawNodes(
            points=points, points_mask=mask,
            initial_poses=np.stack([n.pose for n in self.nodes]),
            timestamps=np.array([n.timestamp for n in self.nodes]),
            odom_i=np.array([x[0] for x in f], np.int64),
            odom_j=np.array([x[1] for x in f], np.int64),
            odom_trans=np.stack([x[2] for x in f]),
            odom_rot=np.array([x[3] for x in f]))


def read_messages(bag_path, lidar_topic: str, odom_topic: str,
                  verbose: bool = True):
    """The bag's lidar and odometry messages in time order, from the native
    C++ reader (native/bagreader.cc); the Python parser runs only where
    the system libbz2 is absent, and then it says so."""
    messages = native.read_bag_native(bag_path, lidar_topic, odom_topic)
    if messages is not None:
        if verbose:
            print("(native bag reader)")
        return messages
    if verbose:
        print("(Python bag reader: the system libbz2 is absent, so the "
              "native reader cannot be built)")
    return read_bag(bag_path, topics=[lidar_topic, odom_topic])


def process_bag_file(bag_path, config, verbose: bool = True,
                     pad_multiple: int = 128) -> RawNodes:
    """ProcessBagFile equivalent (main.cc:46-129): replay the bag's odom +
    lidar topics through the builder."""
    builder = SLAMTypeBuilder(config)
    lidar_topic = config.lidar_topic
    odom_topic = config.odom_topic
    found_lidar = found_odom = False
    count = 0
    messages = read_messages(bag_path, lidar_topic, odom_topic,
                             verbose=verbose)
    for bm in messages:
        if builder.done():
            break
        count += 1
        if isinstance(bm.msg, LaserScanMsg):
            found_lidar = True
            builder.lidar_callback(bm.msg)
        elif isinstance(bm.msg, (OdometryMsg, CobotOdometryMsg)):
            found_odom = True
            builder.odometry_callback(bm.msg)
        if verbose and count % 5000 == 0:
            print(f"Processed {count} messages, found "
                  f"{len(builder.nodes)} nodes.")
    if verbose:
        print("Found lidar messages." if found_lidar
              else "Did not find any lidar scans! Check your topics.")
        print("Found odometry messages." if found_odom
              else "Did not find any odometry messages! Check your topics.")
    return builder.to_raw_nodes(pad_multiple=pad_multiple)
