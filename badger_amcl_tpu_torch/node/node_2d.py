"""2D localization node: the laser-scan pipeline (counterpart of
badger_amcl_tpu.node.node_2d; reference src/amcl/node/node_2d.cpp).

Map receipt with supersampling bakes the distance field and its textures
on the node's device, the range image for the beam model on the "corr"
backends, and (at the first scan) the psi and factor textures, keyed on a
map version bumped at receipt (not on `id()`: CPython recycles ids). Then
the per-frame-id multi-scanner registry with lazily resolved extrinsics,
base-frame angles (upside-down mounts), range clamping, the resample
cadence, cluster-argmax pose extraction, free-space indices, the scan
watchdog, global-localization factor overrides and pose scoring for the
uniform pose generator.

The measurement update is `mcl.sensor_update_2d`, the JAX node's
`_sensor_update_jit` (node_2d.py:39-56): the likelihood-field-prob model
in log space when `laser_likelihood_log_space` is set, every other model
with its factors folded. `_sensor_update_jit` and `_score_poses_jit` are
its graph_jit entries (static model, do_beamskip, backend and log_space),
which the node calls compiled for every model and backend (node.Node).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from badger_amcl_tpu_torch import mcl
from badger_amcl_tpu_torch.config import AMCLConfig, PlanarModelType, resolve_backend
from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D
from badger_amcl_tpu_torch.node import scan_prep
from badger_amcl_tpu_torch.node.messages import LaserScan, OccupancyGrid
from badger_amcl_tpu_torch.node.node import Node
from badger_amcl_tpu_torch.node.transforms import TransformLookupError
from badger_amcl_tpu_torch.sensors.planar import (
    CORR_MODELS,
    PlanarScan,
    PlanarScanParams,
    bake_corr_texture,
    bake_factor_texture,
    planar_likelihood,
)
from badger_amcl_tpu_torch.utils import profiling
from badger_amcl_tpu_torch.utils.graph import graph_jit

log = logging.getLogger("badger_amcl_tpu_torch")

SCAN_WATCHDOG_INTERVAL = 15.0  # node_2d.cpp:107-110
CORR_BACKENDS = ("corr", "corr_q")


def _score_poses(omap, params, scan, poses, model, do_beamskip, backend):
    """scorePose batched (node_2d.cpp:298-316, node_2d.py:59-68): a fake
    1-weight sample set through the full sensor model incl. map factors."""
    n = poses.shape[0]
    p, mf = planar_likelihood(
        omap, params, scan, poses, torch.ones((n,), dtype=torch.bool, device=poses.device),
        torch.full((), n, dtype=torch.int32, device=poses.device), model, converged=False,
        do_beamskip=False, backend=backend, fold_factors=True)
    return p if mf is None else p * mf


# the JAX node's jits (node_2d.py:39-68)
_sensor_update_jit = graph_jit(mcl.sensor_update_2d, static_argnames=(
    "laser_model", "do_beamskip", "backend", "log_space"))
_score_poses_jit = graph_jit(_score_poses, static_argnames=("model", "do_beamskip", "backend"))


def _f32(v) -> float:
    """A config value as the JAX node holds it (jnp.float32), as a Python
    float."""
    return float(np.float32(v))


class Node2D(Node):
    JITS = Node.JITS + (_sensor_update_jit, _score_poses_jit)

    def __init__(self, config: AMCLConfig, tf_buffer=None, seed: int = 0, device="cuda"):
        super().__init__(config, tf_buffer, seed, device)
        self.map: Optional[OccupancyMap2D] = None
        self.first_map_received = False
        self.latest_scan: Optional[PlanarScan] = None
        self.latest_scan_received_ts: Optional[float] = None
        # multi-scanner registry (node_2d.cpp:428-488)
        self.frame_to_scanner: Dict[str, int] = {}
        self.scanner_params: List[PlanarScanParams] = []
        self.scanners_update: List[bool] = []
        self._base_params = self._make_params()
        self.backend = resolve_backend(config.compute_backend, self.device)
        self._map_version = 0
        self._corr_tex_key = None

    # --------------------------------------------------------------- params

    def _make_params(self, scanner_pose=None) -> PlanarScanParams:
        cfg = self.config
        kw = dict(
            z_hit=cfg.laser_z_hit, z_short=cfg.laser_z_short, z_max=cfg.laser_z_max,
            z_rand=cfg.laser_z_rand, sigma_hit=cfg.laser_sigma_hit,
            lambda_short=cfg.laser_lambda_short, gompertz_a=cfg.laser_gompertz_a,
            gompertz_b=cfg.laser_gompertz_b, gompertz_c=cfg.laser_gompertz_c,
            input_shift=cfg.laser_gompertz_input_shift,
            input_scale=cfg.laser_gompertz_input_scale,
            output_shift=cfg.laser_gompertz_output_shift,
            off_map_factor=cfg.laser_off_map_factor,
            non_free_space_factor=cfg.laser_non_free_space_factor,
            non_free_space_radius=cfg.laser_non_free_space_radius,
            beam_skip_distance=cfg.beam_skip_distance,
            beam_skip_threshold=cfg.beam_skip_threshold,
            beam_skip_error_threshold=cfg.beam_skip_error_threshold,
        )
        kw = {k: _f32(v) for k, v in kw.items()}
        if scanner_pose is not None:
            kw["scanner_pose"] = tuple(_f32(v) for v in scanner_pose)
        return PlanarScanParams(**kw)

    def _set_map_factors(self, off_map, non_free, radius):
        """setMapFactors on every scanner (node_2d.cpp:420-425,631-639)."""
        kw = dict(off_map_factor=_f32(off_map), non_free_space_factor=_f32(non_free),
                  non_free_space_radius=_f32(radius))
        self.scanner_params = [dataclasses.replace(p, **kw) for p in self.scanner_params]
        self._base_params = dataclasses.replace(self._base_params, **kw)

    def _apply_normal_factors(self):
        cfg = self.config
        self._set_map_factors(cfg.laser_off_map_factor, cfg.laser_non_free_space_factor,
                              cfg.laser_non_free_space_radius)

    def _apply_global_localization_factors(self):
        cfg = self.config
        self._set_map_factors(cfg.global_localization_laser_off_map_factor,
                              cfg.global_localization_laser_non_free_space_factor,
                              cfg.laser_non_free_space_radius)

    def _reconfigure_sensors(self):
        pose_bak = [p.scanner_pose for p in self.scanner_params]
        self._base_params = self._make_params()
        self.scanner_params = [self._make_params(sp) for sp in pose_bak]
        self._corr_tex_key = None  # params changed: re-bake on the next scan

    def _ensure_corr_texture(self, range_max: float) -> None:
        """Bake the psi texture of the model (and the factor texture) once
        per (map version, model, range_max) on the "corr" backends, as the
        reference bakes its distance LUT at model setup
        (planar_scanner.cpp:67-113)."""
        if self.backend not in CORR_BACKENDS or self.map is None:
            return
        model = self.config.laser_model_type.value
        if model not in CORR_MODELS:
            return
        key = (self._map_version, model, range_max)
        if self._corr_tex_key == key:
            return
        self.map = bake_corr_texture(self.map, self._base_params, range_max, model)
        self.map = bake_factor_texture(self.map, self._base_params)
        self._corr_tex_key = key

    # ------------------------------------------------------------------ map

    def map_msg_received(self, msg: OccupancyGrid) -> None:
        """mapMsgReceived (node_2d.cpp:202-221) + initFromNewMap (:223-259):
        the distance field always (recalcWeight reads it for every model),
        the beam model's range image on the "corr" backends. Spans
        `map.receipt`, `map.field` and `map.free_cells` under a profiler."""
        if self.config.first_map_only and self.first_map_received:
            return
        with profiling.span("map.receipt"):
            log.info("Received a %d X %d occupancy map @ %.3f m/pix", msg.width, msg.height,
                     msg.resolution)
            with profiling.span("map.field"):
                omap = OccupancyMap2D.from_occupancy_grid_msg(
                    msg.width, msg.height, msg.resolution, msg.origin_x, msg.origin_y,
                    msg.data, self.config.map_scale_up_factor, device=self.device)
                omap = omap.with_distance_field(self.config.laser_likelihood_max_dist)
                if (self.config.laser_model_type == PlanarModelType.BEAM
                        and self.backend in CORR_BACKENDS
                        and self.config.beam_range_image_bins > 0):
                    log.info("Baking beam-model range image (%d angle bins)...",
                             self.config.beam_range_image_bins)
                    omap = omap.with_range_image(self.config.beam_range_image_bins)
            # scanners hold map-dependent state: clear the registry (node_2d.cpp:213-217)
            self.frame_to_scanner.clear()
            self.scanner_params = []
            self.scanners_update = []
            self.latest_scan = None
            self._map_version += 1
            self._corr_tex_key = None
            self.init_from_new_map(omap, use_initial_pose=not self.first_map_received)
            with profiling.span("map.free_cells"):
                self._update_free_space_indices()
            self.first_map_received = True

    def _update_free_space_indices(self):
        """updateFreeSpaceIndices (node_2d.cpp:318-338)."""
        fsi = self.map.free_space_indices(self.config.laser_non_free_space_radius)
        origin = np.array([self.map.origin_x, self.map.origin_y])
        half = np.array([self.map.size_x // 2, self.map.size_y // 2])
        self.update_free_space_indices(fsi, origin, half, self.map.resolution)

    # ------------------------------------------------------------- scanners

    def _get_scanner_index(self, frame_id: str) -> int:
        """getFrameToScannerIndex (node_2d.cpp:428-488): lazily resolve the
        base->laser extrinsic; x/y only, mount yaw handled via angle stats."""
        if frame_id in self.frame_to_scanner:
            return self.frame_to_scanner[frame_id]
        try:
            tf = self.tf.lookup(self.config.base_frame_id, frame_id)
        except TransformLookupError:
            log.error("Couldn't transform from %s to %s", frame_id, self.config.base_frame_id)
            return -1
        idx = len(self.scanner_params)
        self.scanner_params.append(dataclasses.replace(
            self._base_params,
            scanner_pose=(_f32(tf.translation[0]), _f32(tf.translation[1]), 0.0)))
        self.scanners_update.append(True)
        self.frame_to_scanner[frame_id] = idx
        return idx

    # ------------------------------------------------------------- pipeline

    def _is_map_initialized(self) -> bool:
        return self.map is not None and self.state is not None and \
            self.map.distances_lut_created

    def scan_received(self, scan: LaserScan, now: Optional[float] = None) -> None:
        """scanReceived (node_2d.cpp:340-360): the root region `scan` of
        utils.profiling."""
        with profiling.scan():
            now = scan.stamp if now is None else now
            self.latest_scan_received_ts = now
            if not self._is_map_initialized():
                return
            if not self.global_localization_active:
                self.deactivate_global_localization_params()
            scanner_index = self._get_scanner_index(scan.frame_id)
            if scanner_index < 0:
                return
            success, force_publication = self.update_pf(scan.stamp, self.scanners_update,
                                                        scanner_index)
            resampled = False
            if success and self.scanners_update[scanner_index]:
                resampled = self._update_scanner(scan, scanner_index)
            if success and (force_publication or resampled):
                self.resample_pose(scan.stamp)

    def _update_scanner(self, scan: LaserScan, scanner_index: int) -> bool:
        """updateScanner (node_2d.cpp:367-392)."""
        cfg = self.config
        try:
            base_to_scanner = self.tf.lookup(cfg.base_frame_id, scan.frame_id, scan.stamp)
        except TransformLookupError:
            log.warning("Unable to transform scanner angles into base frame")
            return False
        with self.timers.phase("scan_prep"):
            ranges, angles, range_max = scan_prep.prepare_scan(
                scan, base_to_scanner, cfg.laser_min_range, cfg.laser_max_range,
                cfg.laser_max_beams, cfg.laser_model_type)
        pscan = PlanarScan(ranges=torch.as_tensor(ranges, device=self.device),
                           angles=torch.as_tensor(angles, device=self.device),
                           range_max=_f32(range_max))
        self.latest_scan = pscan
        self._ensure_corr_texture(pscan.range_max)
        with self.timers.phase("sensor_update"):
            self.state = self._call(
                _sensor_update_jit, self.state, self.map, self.scanner_params[scanner_index],
                pscan, cfg.laser_model_type.value, cfg.do_beamskip, self.backend,
                log_space=self._log_space)
        self.scanners_update[scanner_index] = False
        self.resample_count += 1
        resampled = False
        if self.resample_count % cfg.resample_interval == 0:
            self.resample_particles()
            resampled = True
        if not self.force_update:
            self.publish_particle_cloud(scan.stamp)
        return resampled

    # ------------------------------------------------------------- scoring

    def score_poses(self, poses: torch.Tensor) -> torch.Tensor:
        """scorePose batched (node_2d.cpp:298-316): a fake 1-weight sample
        set through the full sensor model incl. map factors."""
        if self.latest_scan is None:
            return torch.ones((poses.shape[0],), dtype=torch.float32, device=self.device)
        return self._call(_score_poses_jit, self.map, self._base_params, self.latest_scan,
                          poses, self.config.laser_model_type.value, False, self.backend)

    # ------------------------------------------------------------- watchdog

    def check_scan_received(self, now: float) -> Optional[str]:
        """checkScanReceived (node_2d.cpp:619-627): a warning string when no
        scan has arrived for 15 s (the app decides how to surface it)."""
        if self.latest_scan_received_ts is None:
            return None
        d = now - self.latest_scan_received_ts
        if d > SCAN_WATCHDOG_INTERVAL:
            msg = (f"No planar scan received (and thus no pose updates have been "
                   f"published) for {d:.1f} seconds.")
            log.warning(msg)
            return msg
        return None
