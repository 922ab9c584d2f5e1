"""Message dataclasses — the framework's I/O contract (a copy of
badger_amcl_tpu.node.messages: numpy only).

ROS-free equivalents of the message types the reference subscribes to and
publishes (SURVEY.md §1-L3). A thin rospy/rclpy bridge can map these 1:1;
the sim/replay harness produces them directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LaserScan:
    """sensor_msgs/LaserScan (consumed at node_2d.cpp:340-360)."""

    stamp: float
    frame_id: str
    angle_min: float
    angle_increment: float
    range_min: float
    range_max: float
    ranges: np.ndarray  # (R,) float


@dataclasses.dataclass
class PointCloud2:
    """sensor_msgs/PointCloud2 (consumed at node_3d.cpp:320-340)."""

    stamp: float
    frame_id: str
    points: np.ndarray  # (K, 3) float, in the scanner frame


@dataclasses.dataclass
class OccupancyGrid:
    """nav_msgs/OccupancyGrid (consumed at node_2d.cpp:202-221)."""

    width: int
    height: int
    resolution: float
    origin_x: float
    origin_y: float
    data: np.ndarray  # (H*W,) int8: 0 free, 100 occupied, else unknown


@dataclasses.dataclass
class OctomapMsg:
    """octomap_msgs/Octomap (consumed at node_3d.cpp:199-218; decode branch
    `binary ? binaryMsgToMap : fullMsgToMap` at node_3d.cpp:262-284). One of:
    a complete binary .bt byte stream, a complete full .ot byte stream, or a
    pre-parsed occupied-centers array."""

    resolution: float
    binary_data: Optional[bytes] = None
    full_data: Optional[bytes] = None  # full-format (.ot) stream incl. header
    occupied_centers: Optional[np.ndarray] = None  # (K, 3) world meters


@dataclasses.dataclass
class Odometry:
    """nav_msgs/Odometry (consumed by the odom integrator, node.cpp:726-744)."""

    stamp: float
    pose: np.ndarray  # (3,) x, y, yaw of base in odom frame


@dataclasses.dataclass
class PoseWithCovarianceStamped:
    """geometry_msgs/PoseWithCovarianceStamped (initialpose intake /
    amcl_pose output, node.cpp:359-444,965-1002)."""

    stamp: float
    frame_id: str
    pose: np.ndarray  # (3,) x, y, yaw
    covariance: np.ndarray  # (36,) row-major 6x6

    @staticmethod
    def make(stamp, frame_id, pose, cov3: Optional[np.ndarray] = None):
        cov = np.zeros(36)
        if cov3 is not None:
            cov[0] = cov3[0]
            cov[7] = cov3[1]
            cov[35] = cov3[2]
        return PoseWithCovarianceStamped(stamp, frame_id, np.asarray(pose, float), cov)


@dataclasses.dataclass
class PoseArray:
    """geometry_msgs/PoseArray (particlecloud output, node.cpp:335-357)."""

    stamp: float
    frame_id: str
    poses: np.ndarray  # (N, 3)


@dataclasses.dataclass
class TransformStamped:
    """map->odom TF output (node.cpp:885-921)."""

    stamp: float
    frame_id: str
    child_frame_id: str
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # quaternion (x, y, z, w)


@dataclasses.dataclass
class Pose2D:
    """geometry_msgs/Pose2D (amcl_absolute_motion output, node.cpp:1080-1084)."""

    x: float
    y: float
    theta: float


# 6x6 covariance indices used by the reference (node.h)
COVARIANCE_XX = 0
COVARIANCE_YY = 7
COVARIANCE_AA = 35
