"""Synthetic world harness (counterpart of badger_amcl_tpu.sim.simulator).

The reference's de-facto integration spec is its example launch files plus
live robot data; it ships no simulator (SURVEY.md §4). This harness closes
that gap: a synthetic occupancy world, a scripted trajectory, raycast- or
distance-sampled sensor data, and simulated odometry (with drift/noise)
feeding the node layer exactly the messages a ROS bridge would.

A simulator is the world, not the filter: it lives on the host (its map
on the CPU, its messages numpy) whatever device the node runs on. Its
draws come from one seeded torch.Generator on the CPU, where the JAX
simulator splits a PRNG key (`_next_key`), so the two streams differ;
the same seed gives the same stream.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D
from badger_amcl_tpu_torch.node.messages import LaserScan, OccupancyGrid, Odometry, PointCloud2
from badger_amcl_tpu_torch.node.transforms import Transform, TransformBuffer
from badger_amcl_tpu_torch.scenario import linspace_f32
from badger_amcl_tpu_torch.sensors.raycast import calc_range


def make_room_grid(n: int = 240, resolution: float = 0.05, n_pillars: int = 12,
                   seed: int = 42) -> OccupancyGrid:
    """An n x n cell room with border walls and random pillars, as an
    OccupancyGrid message (origin placed so the map is centered at 0,0 after
    the node's center-origin conversion)."""
    data = np.zeros((n, n), np.int8)
    data[0:2, :] = data[-2:, :] = 100
    data[:, 0:2] = data[:, -2:] = 100
    rng = np.random.default_rng(seed)
    for _ in range(n_pillars):
        cx, cy = rng.integers(n // 8, n - n // 8, 2)
        data[cy: cy + 8, cx: cx + 8] = 100
    return OccupancyGrid(
        width=n, height=n, resolution=resolution,
        origin_x=-n * resolution / 2.0, origin_y=-n * resolution / 2.0,
        data=data.ravel(),
    )


class _Kinematics:
    """True-pose unicycle kinematics and drifting odometry, published as the
    odom->base TF; the shared half of Sim2D and Sim3D."""

    def __init__(self, start_pose, odom_noise, scanner_frame, scanner_mount, base_frame,
                 seed):
        self.true_pose = np.asarray(start_pose, float).copy()
        self.odom_pose = self.true_pose.copy()  # odom frame == map at t=0
        self.odom_noise = np.asarray(odom_noise)
        self.scanner_frame = scanner_frame
        self.scanner_mount = scanner_mount or Transform.identity()
        self.generator = torch.Generator().manual_seed(seed)
        self.t = 0.0
        self.base_frame = base_frame
        self.tf = TransformBuffer()
        self.tf.set_static(base_frame, scanner_frame, self.scanner_mount)
        self._publish_odom_tf()

    def _normal(self, *shape) -> np.ndarray:
        return torch.randn(shape, generator=self.generator, dtype=torch.float32).numpy()

    def _publish_odom_tf(self):
        self.tf.set_transform(
            "odom", self.base_frame, self.t, Transform.from_pose2d(self.odom_pose)
        )

    def teleport(self, pose):
        """Kidnap the robot: the true pose jumps, odometry doesn't notice."""
        self.true_pose = np.asarray(pose, float).copy()

    def step(self, v: float, w: float, dt: float = 0.1):
        """Advance kinematics: unicycle model. Returns (odom_msg)."""
        self.t += dt
        self.true_pose[0] += v * dt * math.cos(self.true_pose[2])
        self.true_pose[1] += v * dt * math.sin(self.true_pose[2])
        self.true_pose[2] += w * dt
        noise = self._normal(3) * self.odom_noise
        self.odom_pose[0] += v * dt * math.cos(self.odom_pose[2]) + noise[0]
        self.odom_pose[1] += v * dt * math.sin(self.odom_pose[2]) + noise[1]
        self.odom_pose[2] += w * dt + noise[2]
        self._publish_odom_tf()
        return Odometry(self.t, self.odom_pose.copy())


class Sim2D(_Kinematics):
    """Drives a Node2D: true-pose kinematics, simulated odometry TF + topic,
    raycast laser scans."""

    def __init__(
        self,
        grid: OccupancyGrid,
        start_pose=(0.0, 0.0, 0.0),
        n_beams: int = 180,
        range_max: float = 8.0,
        range_noise: float = 0.01,
        odom_noise=(0.002, 0.002, 0.001),
        scanner_frame: str = "laser",
        scanner_mount: Optional[Transform] = None,
        base_frame: str = "base_link",
        seed: int = 1,
    ):
        self.grid = grid
        self.world = OccupancyMap2D.from_occupancy_grid_msg(
            grid.width, grid.height, grid.resolution, grid.origin_x, grid.origin_y,
            grid.data, device="cpu",
        )
        self.n_beams = n_beams
        self.range_max = range_max
        self.range_noise = range_noise
        self._beam_angles = linspace_f32(-math.pi * 0.75, math.pi * 0.75, n_beams)
        super().__init__(start_pose, odom_noise, scanner_frame, scanner_mount, base_frame,
                         seed)

    def make_scan(self) -> LaserScan:
        """Raycast a scan from the true pose (through the scanner mount)."""
        mount = Transform.from_pose2d(self.true_pose).compose(self.scanner_mount)
        sx, sy, syaw = mount.to_pose2d()
        f32 = np.float32
        r = calc_range(
            self.world,
            torch.tensor(f32(sx)),
            torch.tensor(f32(sy)),
            torch.from_numpy(f32(syaw) + self._beam_angles),
            self.range_max,
        ).numpy()
        noise = f32(self.range_noise) * self._normal(self.n_beams)
        r = np.clip(r + noise, f32(0.0), f32(self.range_max)).astype(f32)
        return LaserScan(
            stamp=self.t, frame_id=self.scanner_frame,
            angle_min=float(self._beam_angles[0]),
            angle_increment=float(self._beam_angles[1] - self._beam_angles[0]),
            range_min=0.05, range_max=self.range_max,
            ranges=r,
        )


class Sim3D(_Kinematics):
    """Drives a Node3D: a synthetic voxel world (walls + columns), point
    clouds sampled around occupied voxels near the true pose."""

    def __init__(
        self,
        occupied_centers: np.ndarray,
        resolution: float,
        start_pose=(1.0, 1.0, 0.0),
        n_points: int = 256,
        scanner_frame: str = "lidar",
        scanner_mount: Optional[Transform] = None,
        noise: float = 0.01,
        odom_noise=(0.002, 0.002, 0.001),
        base_frame: str = "base_link",
        seed: int = 2,
    ):
        self.occupied = np.asarray(occupied_centers, float)
        self.resolution = resolution
        self.n_points = n_points
        self.noise = noise
        super().__init__(start_pose, odom_noise, scanner_frame, scanner_mount, base_frame,
                         seed)

    def make_cloud(self) -> PointCloud2:
        """Sample surface points from the occupied set, expressed in the
        scanner frame."""
        idx = torch.randint(0, len(self.occupied), (self.n_points,),
                            generator=self.generator).numpy()
        pts_world = self.occupied[idx] + self._normal(self.n_points, 3) * self.noise
        t_map_scanner = Transform.from_pose2d(self.true_pose).compose(self.scanner_mount)
        pts_scanner = t_map_scanner.inverse().apply(pts_world)
        return PointCloud2(stamp=self.t, frame_id=self.scanner_frame, points=pts_scanner)
