"""Carry JAX-package objects over to the port.

Each function reads the attributes of a badger_amcl_tpu object, takes them
through `np.asarray` and builds the port's counterpart on `device`. Nothing
here imports JAX: the caller holds the JAX objects, and `np.asarray` copies
their device buffers to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
from badger_amcl_tpu_torch.pf.types import ClusterStats, MCLState, PFParams
from badger_amcl_tpu_torch.sensors.planar import PlanarScan, PlanarScanParams
from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams


def _t(x, device, dtype=None):
    a = np.asarray(x)
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _opt(x, device):
    return None if x is None else _t(x, device)


def map_from_numpy(omap, device="cuda") -> OccupancyMap2D:
    """OccupancyMap2D (JAX) -> OccupancyMap2D (port), the range image, its
    transpose and the baked psi (f32 and int8) and factor textures included
    with their fingerprints; the int8 and bf16 distance textures are baked
    from the distances, as `with_distance_field` bakes them."""
    omap = OccupancyMap2D(
        resolution=float(omap.resolution), size_x=int(omap.size_x),
        size_y=int(omap.size_y), origin_x=float(omap.origin_x),
        origin_y=float(omap.origin_y),
        cells=_t(omap.cells, device, torch.int8),
        distances=_opt(omap.distances, device),
        max_distance_to_object=float(omap.max_distance_to_object),
        range_image=_opt(omap.range_image, device),
        range_rows=_opt(omap.range_rows, device),
        corr_psi_pad=_opt(omap.corr_psi_pad, device),
        corr_psi_key=omap.corr_psi_key,
        corr_psi_pad_q=_opt(omap.corr_psi_pad_q, device),
        corr_psi_q=_opt(omap.corr_psi_q, device),
        factor_tex=_opt(omap.factor_tex, device),
        factor_key=omap.factor_key,
    )
    if omap.distances is None:
        return omap
    return omap.with_distance_bakes()


def stats_from_numpy(stats, device="cuda") -> ClusterStats:
    return ClusterStats(**{
        f: _t(getattr(stats, f), device)
        for f in ("cluster_count", "cluster_valid", "cluster_weights",
                  "cluster_counts", "cluster_means", "cluster_covs", "mean",
                  "cov", "particle_cluster")})


def state_from_numpy(state, device="cuda") -> MCLState:
    """MCLState (JAX) -> MCLState (port); the PRNG key is not carried. A
    stacked fleet state (leading robot axis) converts to the port's fleet
    state."""
    return MCLState(
        poses=_t(state.poses, device, torch.float32),
        weights=_t(state.weights, device, torch.float32),
        n_active=_t(state.n_active, device, torch.int32),
        w_slow=_t(state.w_slow, device, torch.float32),
        w_fast=_t(state.w_fast, device, torch.float32),
        alpha_slow=_t(state.alpha_slow, device, torch.float32),
        alpha_fast=_t(state.alpha_fast, device, torch.float32),
        converged=_t(state.converged, device, torch.bool),
        stats=stats_from_numpy(state.stats, device),
    )


def scan_from_numpy(scan, device="cuda") -> PlanarScan:
    return PlanarScan(ranges=_t(scan.ranges, device, torch.float32),
                      angles=_t(scan.angles, device, torch.float32),
                      range_max=float(np.asarray(scan.range_max)))


def fleet_scan_from_numpy(scans, device="cuda"):
    """A stacked PlanarScan (JAX: ranges/angles (R, B), range_max (R,)) ->
    fleet.FleetScan."""
    from badger_amcl_tpu_torch.fleet import FleetScan

    return FleetScan(ranges=_t(scans.ranges, device, torch.float32),
                     angles=_t(scans.angles, device, torch.float32),
                     range_max=tuple(float(v) for v in np.asarray(scans.range_max)))


def scan_params_from_numpy(params) -> PlanarScanParams:
    """Every planar model parameter as a Python float."""
    kw = {f.name: float(np.asarray(getattr(params, f.name)))
          for f in dataclasses.fields(PlanarScanParams) if f.name != "scanner_pose"}
    kw["scanner_pose"] = tuple(float(v) for v in np.asarray(params.scanner_pose))
    return PlanarScanParams(**kw)


def pf_params_from_jax(params) -> PFParams:
    """PFParams (JAX, static fields) -> PFParams (port)."""
    return PFParams(**{f: getattr(params, f) for f in (
        "min_samples", "max_samples", "pop_err", "pop_z", "dist_threshold",
        "convergence_threshold", "hist_x", "hist_y", "hist_a",
        "stats_max_clusters")})


def octomap_from_numpy(omap, device="cuda") -> OctoMap3D:
    """OctoMap3D (JAX) -> OctoMap3D (port); the (nx, ny, nz) uint8 ratios
    become the port's z-major texture."""
    tex = None
    if omap.distances_u8 is not None:
        tex = torch.from_numpy(np.ascontiguousarray(
            np.asarray(omap.distances_u8, np.uint8).transpose(2, 1, 0))).to(device)
    return OctoMap3D(
        resolution=float(omap.resolution),
        max_distance_to_object=float(omap.max_distance_to_object),
        min_cells=tuple(int(v) for v in omap.min_cells),
        max_cells=tuple(int(v) for v in omap.max_cells),
        occupied_cells=np.array(omap.occupied_cells, dtype=np.int32, copy=True),
        device=torch.device(device), tex_zyx=tex,
    )


def pc_params_from_numpy(params) -> PointCloudParams:
    """Point-cloud model parameters as Python floats."""
    return PointCloudParams(**{
        f.name: float(np.asarray(getattr(params, f.name)))
        for f in dataclasses.fields(PointCloudParams)})


def config_from_jax(config):
    """AMCLConfig (JAX package) -> the port's AMCLConfig, field by field
    (enums by their value)."""
    from badger_amcl_tpu_torch.config import AMCLConfig

    kw = {}
    for f in dataclasses.fields(AMCLConfig):
        v = getattr(config, f.name)
        kw[f.name] = getattr(v, "value", v)
    return AMCLConfig(**kw)


def message_from_jax(msg):
    """A JAX-package node message (LaserScan, Odometry, OccupancyGrid,
    PoseWithCovarianceStamped, ...) -> the port's message of the same name,
    its arrays copied."""
    from badger_amcl_tpu_torch.node import messages

    cls = getattr(messages, type(msg).__name__)
    return cls(**{f.name: (np.array(getattr(msg, f.name), copy=True)
                           if isinstance(getattr(msg, f.name), np.ndarray)
                           else getattr(msg, f.name))
                  for f in dataclasses.fields(cls)})

