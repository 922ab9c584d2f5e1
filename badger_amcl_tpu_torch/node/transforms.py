"""Minimal frame-transform machinery replacing tf2/tf2_ros (a copy of
badger_amcl_tpu.node.transforms: numpy only).

The reference leans on tf2 for three things (node.h:48-52):
- odom->base lookup at scan stamps (getOdomPose, node.cpp:795-820)
- static base->scanner extrinsics (node_2d.cpp:450-476, node_3d.cpp:429-443)
- frame gating of scans (tf2_ros::MessageFilter)

This module provides just enough SE(3): quaternions, rigid transforms with
compose/inverse, yaw extraction, and a `TransformBuffer` holding static
transforms plus a time-indexed odom track with interpolation. Host-side
numpy — transforms are I/O plumbing, not device math.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class TransformLookupError(KeyError):
    """Raised when a frame pair/time cannot be resolved (the reference wraps
    every tf2 lookup in try/catch with skip-and-log semantics)."""


def quat_from_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """(x, y, z, w) quaternion from roll/pitch/yaw (tf2 setRPY convention)."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v (…,3) by quaternion q."""
    x, y, z, w = q
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    return np.asarray(v) @ r.T


def quat_yaw(q: np.ndarray) -> float:
    """Yaw of a quaternion (tf2::getYaw)."""
    x, y, z, w = q
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rigid SE(3) transform: p_parent = rotation * p_child + translation."""

    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # quaternion (x, y, z, w)

    @staticmethod
    def identity() -> "Transform":
        return Transform(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))

    @staticmethod
    def from_xyzrpy(x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0, yaw=0.0) -> "Transform":
        return Transform(np.array([x, y, z], float), quat_from_rpy(roll, pitch, yaw))

    @staticmethod
    def from_pose2d(pose) -> "Transform":
        """(x, y, yaw) -> planar transform."""
        x, y, yaw = float(pose[0]), float(pose[1]), float(pose[2])
        return Transform(np.array([x, y, 0.0]), quat_from_rpy(0.0, 0.0, yaw))

    def compose(self, other: "Transform") -> "Transform":
        """self * other (apply `other` first)."""
        return Transform(
            self.translation + quat_rotate(self.rotation, other.translation),
            quat_multiply(self.rotation, other.rotation),
        )

    def inverse(self) -> "Transform":
        qinv = self.rotation * np.array([-1.0, -1.0, -1.0, 1.0])
        return Transform(-quat_rotate(qinv, self.translation), qinv)

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Transform points (…,3)."""
        return quat_rotate(self.rotation, points) + self.translation

    @property
    def yaw(self) -> float:
        return quat_yaw(self.rotation)

    def to_pose2d(self) -> np.ndarray:
        return np.array([self.translation[0], self.translation[1], self.yaw])


def _interp_transform(a: Transform, b: Transform, t: float) -> Transform:
    """Linear translation + nlerp rotation (sufficient for odom tracks)."""
    q1, q2 = a.rotation, b.rotation
    if np.dot(q1, q2) < 0:
        q2 = -q2
    q = (1 - t) * q1 + t * q2
    q = q / np.linalg.norm(q)
    return Transform((1 - t) * a.translation + t * b.translation, q)


class TransformBuffer:
    """Static transforms + per-pair timed tracks with interpolation.

    `lookup(parent, child, time)` resolves a direct edge or its inverse (one
    hop — all the frames AMCL touches are directly connected: map, odom,
    base, scanner frames)."""

    def __init__(self):
        self._static: Dict[Tuple[str, str], Transform] = {}
        self._timed: Dict[Tuple[str, str], Tuple[List[float], List[Transform]]] = {}

    def set_static(self, parent: str, child: str, tf: Transform) -> None:
        self._static[(parent, child)] = tf

    def set_transform(self, parent: str, child: str, time: float, tf: Transform) -> None:
        times, tfs = self._timed.setdefault((parent, child), ([], []))
        if times and time < times[-1]:
            idx = bisect.bisect_left(times, time)
            times.insert(idx, time)
            tfs.insert(idx, tf)
        else:
            times.append(time)
            tfs.append(tf)

    def can_transform(self, parent: str, child: str, time: Optional[float] = None) -> bool:
        try:
            self.lookup(parent, child, time)
            return True
        except TransformLookupError:
            return False

    def _lookup_direct(self, parent, child, time):
        if (parent, child) in self._static:
            return self._static[(parent, child)]
        if (parent, child) in self._timed:
            times, tfs = self._timed[(parent, child)]
            if not times:
                raise TransformLookupError(f"no data for {parent}->{child}")
            if time is None:
                return tfs[-1]
            idx = bisect.bisect_left(times, time)
            if idx == 0:
                return tfs[0]
            if idx >= len(times):
                return tfs[-1]
            t0, t1 = times[idx - 1], times[idx]
            frac = 0.0 if t1 == t0 else (time - t0) / (t1 - t0)
            return _interp_transform(tfs[idx - 1], tfs[idx], frac)
        return None

    def lookup(self, parent: str, child: str, time: Optional[float] = None) -> Transform:
        if parent == child:
            return Transform.identity()
        direct = self._lookup_direct(parent, child, time)
        if direct is not None:
            return direct
        inverse = self._lookup_direct(child, parent, time)
        if inverse is not None:
            return inverse.inverse()
        raise TransformLookupError(f"cannot transform {parent}->{child}")
