"""3D localization node: the point-cloud pipeline (counterpart of
badger_amcl_tpu.node.node_3d; reference src/amcl/node/node_3d.cpp).

Octomap receipt (binary .bt, full .ot or occupied centres) into a voxel
EDT on the node's device, baked at once or deferred until the 2D
occupancy map supplies crop bounds; cloud decimation; the per-frame-id
scanner registry with full SE(3) footprint extrinsics, folded into the
cloud once per scan; the resample cadence, cluster-argmax pose
extraction, the scan watchdog, global-localization factor overrides and
pose scoring for the uniform pose generator, all shared with the 2D node
through `node.Node`.

The measurement update composes `point_cloud_likelihood` and
`pf.filter.sensor_update` as the JAX node's `_sensor_update_jit`
(node_3d.py:37-41); it and `_score_poses_jit` are graph_jit entries
(static model and backend; the windowed arm's predicate a conditional
node), which the node calls compiled: every 3D configuration lies inside
the compiled slice but the capped statistics. The point-cloud models
have no int8 table: on "corr_q" (the JAX package's "pallas_corr_q") the
likelihood takes the exact gather, as the JAX dispatch sends that name to
its XLA gather (point_cloud.py:133,178).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from badger_amcl_tpu_torch.config import AMCLConfig, resolve_backend
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
from badger_amcl_tpu_torch.maps.octree_io import read_bt, read_ot
from badger_amcl_tpu_torch.node import scan_prep
from badger_amcl_tpu_torch.node.messages import OccupancyGrid, OctomapMsg, PointCloud2
from badger_amcl_tpu_torch.node.node import Node
from badger_amcl_tpu_torch.node.node_2d import _f32
from badger_amcl_tpu_torch.node.transforms import Transform, TransformLookupError
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams, point_cloud_likelihood
from badger_amcl_tpu_torch.utils import profiling
from badger_amcl_tpu_torch.utils.graph import graph_jit

log = logging.getLogger("badger_amcl_tpu_torch")

SCAN_WATCHDOG_INTERVAL = 15.0  # node_3d.cpp:102-105


def _sensor_update(state, omap, params, points_base, model, backend):
    p, mf = point_cloud_likelihood(omap, params, points_base, state.poses, model, backend)
    return pf_filter.sensor_update(state, p, mf)


def _score_poses(omap, params, points_base, poses, model, backend):
    p, mf = point_cloud_likelihood(omap, params, points_base, poses, model, backend)
    return p * mf


# the JAX node's jits (node_3d.py:37-47)
_sensor_update_jit = graph_jit(_sensor_update, static_argnames=("model", "backend"))
_score_poses_jit = graph_jit(_score_poses, static_argnames=("model", "backend"))


def cloud_backend(name: str, device) -> str:
    """The point-cloud backend of a configured compute_backend: as
    `config.resolve_backend`, with "corr_q" on the exact gather."""
    backend = resolve_backend(name, device)
    return "exact" if backend == "corr_q" else backend


class Node3D(Node):
    JITS = Node.JITS + (_sensor_update_jit, _score_poses_jit)

    def __init__(self, config: AMCLConfig, tf_buffer=None, seed: int = 0, device="cuda"):
        super().__init__(config, tf_buffer, seed, device)
        self.map: Optional[OctoMap3D] = None
        self.first_octomap_received = False
        self.first_occupancy_map_received = False
        self.occupancy_bounds_received = False
        self.occupancy_map_min = None
        self.occupancy_map_max = None
        self.latest_points_base: Optional[torch.Tensor] = None
        self.latest_scan_received_ts: Optional[float] = None
        # per-frame scanner registry (node_3d.cpp:400-451)
        self.frame_to_scanner: Dict[str, int] = {}
        self.scanner_tfs: List[Transform] = []
        self.scanners_update: List[bool] = []
        self.pc_params = self._make_params()
        self.backend = cloud_backend(config.compute_backend, self.device)

    # --------------------------------------------------------------- params

    def _make_params(self) -> PointCloudParams:
        cfg = self.config
        return PointCloudParams(
            z_hit=_f32(cfg.laser_z_hit), z_rand=_f32(cfg.laser_z_rand),
            sigma_hit=_f32(cfg.laser_sigma_hit), gompertz_a=_f32(cfg.laser_gompertz_a),
            gompertz_b=_f32(cfg.laser_gompertz_b), gompertz_c=_f32(cfg.laser_gompertz_c),
            input_shift=_f32(cfg.laser_gompertz_input_shift),
            input_scale=_f32(cfg.laser_gompertz_input_scale),
            output_shift=_f32(cfg.laser_gompertz_output_shift),
            off_map_factor=_f32(cfg.laser_off_map_factor),
            non_free_space_factor=_f32(cfg.laser_non_free_space_factor),
            non_free_space_radius=_f32(cfg.laser_non_free_space_radius))

    def _apply_normal_factors(self):
        cfg = self.config
        self.pc_params = dataclasses.replace(
            self.pc_params, off_map_factor=_f32(cfg.laser_off_map_factor),
            non_free_space_factor=_f32(cfg.laser_non_free_space_factor),
            non_free_space_radius=_f32(cfg.laser_non_free_space_radius))

    def _apply_global_localization_factors(self):
        cfg = self.config
        self.pc_params = dataclasses.replace(
            self.pc_params, off_map_factor=_f32(cfg.global_localization_laser_off_map_factor),
            non_free_space_factor=_f32(cfg.global_localization_laser_non_free_space_factor))

    def _reconfigure_sensors(self):
        self.pc_params = self._make_params()

    # ------------------------------------------------------------------ maps

    def octomap_msg_received(self, msg: OctomapMsg) -> None:
        """octoMapMsgReceived (node_3d.cpp:199-218) + initFromNewMap
        (:220-256): build the OctoMap, bake the EDT now or defer until the
        occupancy map bounds arrive. Spans `map.receipt`, `map.field` (the
        voxel table, and its EDT where it is baked now) and `map.free_cells`
        under a profiler."""
        if self.config.first_map_only and self.first_octomap_received:
            return
        with profiling.span("map.receipt"):
            log.info("Received a new Octomap")
            max_dist = self.config.resolved_cloud_likelihood_max_dist
            with profiling.span("map.field"):
                if msg.binary_data is not None:
                    omap = OctoMap3D.from_binary_octree(read_bt(msg.binary_data), max_dist,
                                                        self.device)
                elif msg.full_data is not None:
                    # fullMsgToMap branch (node_3d.cpp:270-273): full probabilistic
                    # tree, leaves thresholded at logodds > 0
                    omap = OctoMap3D.from_binary_octree(read_ot(msg.full_data), max_dist,
                                                        self.device)
                else:
                    omap = OctoMap3D.from_occupied_points(msg.occupied_centers,
                                                          msg.resolution, max_dist,
                                                          device=self.device)
            self.frame_to_scanner.clear()
            self.scanner_tfs = []
            self.scanners_update = []
            self.latest_points_base = None
            self.init_from_new_map(omap, use_initial_pose=not self.first_octomap_received)
            if self.config.wait_for_occupancy_map and self.occupancy_bounds_received:
                with profiling.span("map.field"):
                    self.map = self.map.set_map_bounds(self.occupancy_map_min,
                                                       self.occupancy_map_max)
                with profiling.span("map.free_cells"):
                    self._update_free_space_indices()
            elif not self.config.wait_for_occupancy_map:
                with profiling.span("map.field"):
                    self.map = self.map.with_distance_field()
                with profiling.span("map.free_cells"):
                    self._update_free_space_indices()
            self.first_octomap_received = True

    def occupancy_map_msg_received(self, msg: OccupancyGrid) -> None:
        """occupancyMapMsgReceived (node_3d.cpp:178-197): the 2D map supplies
        crop bounds for the voxel EDT. Reference quirk preserved: the min
        bound is hard-coded {0, 0} and the grid's origin is ignored
        (node_3d.cpp:189-190); setMapBounds pads by max_distance_to_object
        and intersects with the octree's own extent."""
        cfg = self.config
        if not cfg.wait_for_occupancy_map or (
                cfg.first_map_only and self.first_occupancy_map_received):
            return
        self.first_occupancy_map_received = True
        s = cfg.map_scale_up_factor
        resolution = msg.resolution / s
        w, h = msg.width * s, msg.height * s
        self.occupancy_map_min = [0.0, 0.0]
        self.occupancy_map_max = [w * resolution, h * resolution]
        self.occupancy_bounds_received = True
        if self.first_octomap_received:
            self.map = self.map.set_map_bounds(self.occupancy_map_min, self.occupancy_map_max)
            self._update_free_space_indices()

    def _update_free_space_indices(self):
        """updateFreeSpaceIndices (node_3d.cpp:306-318): all in-bounds (i, j);
        3D maps use the zero-origin convention (world = cell * res)."""
        self.update_free_space_indices(self.map.free_space_indices(), np.zeros(2),
                                       np.zeros(2, np.int32), self.map.resolution)

    # ------------------------------------------------------------- scanners

    def _get_scanner_index(self, frame_id: str) -> int:
        """getFrameToScannerIndex (node_3d.cpp:400-451): full SE(3) footprint
        extrinsic per frame."""
        if frame_id in self.frame_to_scanner:
            return self.frame_to_scanner[frame_id]
        try:
            tf = self.tf.lookup(self.config.base_frame_id, frame_id)
        except TransformLookupError:
            log.error("Failed to get transform from base footprint to %s", frame_id)
            return -1
        idx = len(self.scanner_tfs)
        self.scanner_tfs.append(tf)
        self.scanners_update.append(True)
        self.frame_to_scanner[frame_id] = idx
        return idx

    # ------------------------------------------------------------- pipeline

    def _is_map_initialized(self) -> bool:
        return self.map is not None and self.state is not None and \
            self.map.distances_lut_created

    def scan_received(self, cloud: PointCloud2, now: Optional[float] = None) -> None:
        """scanReceived (node_3d.cpp:320-340): the root region `scan` of
        utils.profiling."""
        with profiling.scan():
            now = cloud.stamp if now is None else now
            self.latest_scan_received_ts = now
            if not self._is_map_initialized():
                return
            if not self.global_localization_active:
                self.deactivate_global_localization_params()
            scanner_index = self._get_scanner_index(cloud.frame_id)
            if scanner_index < 0:
                return
            success, force_publication = self.update_pf(cloud.stamp, self.scanners_update,
                                                        scanner_index)
            resampled = False
            if success and self.scanners_update[scanner_index]:
                resampled = self._update_scanner(cloud, scanner_index)
            if success and (force_publication or resampled):
                self.resample_pose(cloud.stamp)

    def _update_scanner(self, cloud: PointCloud2, scanner_index: int) -> bool:
        """updateScanner (node_3d.cpp:348-365): decimate to max_beams points
        (:467-480), fold the scanner->footprint extrinsic into the cloud once
        (the reference redoes it per particle in getMapCloud)."""
        cfg = self.config
        with self.timers.phase("scan_prep"):
            pts = scan_prep.decimate_cloud(cloud.points, cfg.resolved_cloud_max_beams)
            pts_base = self.scanner_tfs[scanner_index].apply(pts)
            self.latest_points_base = torch.as_tensor(np.asarray(pts_base, np.float32),
                                                      device=self.device)
        with self.timers.phase("sensor_update"):
            self.state = self._call(_sensor_update_jit, self.state, self.map, self.pc_params,
                                    self.latest_points_base, cfg.point_cloud_model_type.value,
                                    self.backend)
        self.scanners_update[scanner_index] = False
        self.resample_count += 1
        resampled = False
        if self.resample_count % cfg.resample_interval == 0:
            self.resample_particles()
            resampled = True
        if not self.force_update:
            self.publish_particle_cloud(cloud.stamp)
        return resampled

    # ------------------------------------------------------------- scoring

    def score_poses(self, poses: torch.Tensor) -> torch.Tensor:
        """scorePose batched (node_3d.cpp:286-304)."""
        if self.latest_points_base is None:
            return torch.ones((poses.shape[0],), dtype=torch.float32, device=self.device)
        return self._call(_score_poses_jit, self.map, self.pc_params, self.latest_points_base,
                          poses, self.config.point_cloud_model_type.value, self.backend)

    # ------------------------------------------------------------- watchdog

    def check_scan_received(self, now: float) -> Optional[str]:
        """checkScanReceived (node_3d.cpp:542-550)."""
        if self.latest_scan_received_ts is None:
            return None
        d = now - self.latest_scan_received_ts
        if d > SCAN_WATCHDOG_INTERVAL:
            msg = f"No point cloud scan received for {d:.1f} seconds."
            log.warning(msg)
            return msg
        return None
