"""Seeded scenario builders: the port's JAX-free twins of the JAX
package's `__graft_entry__._build_setup` (2D) and of the 3D scene of
`benchmarks/parity_tpu.py:run_3d`.

2D: the map comes from the same `np.random.default_rng(seed)` recipe, so
its cells are bit-identical, and the scan follows the same formulas (the
angles reproduce jnp.linspace's f32 arithmetic). The psi and factor
textures are baked as the JAX setup bakes them.

Fleet: `build_fleet` is the set-up of the JAX fleet benchmark
(`benchmarks/run_all.py:260-309`): R robots near the map's centre, each
with its own cloud, the scenario scan tiled over the robots.

3D: a structured 20 x 20 x 1 m scene at 0.05 m (border walls and 14
columns of occupied voxels, a 401 x 401 x 21 voxel EDT) and a cloud of
points sampled from the occupied set around the true pose, expressed in
the base frame, with the same `np.random.default_rng(3)` draws in the same
order, so the occupied set and the 256-point cloud are bit-identical.

Initial poses and the random-pose pool come from torch.Generators seeded
with seed and seed + 1, so they differ from the JAX package's draws in
value, not in law.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.fleet import FleetScan, fleet_init
from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf.types import PFParams
from badger_amcl_tpu_torch.sensors.planar import (
    PlanarScan, PlanarScanParams, bake_corr_texture, bake_factor_texture,
)
from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams

RANGE_MAX = 8.0
RESOLUTION = 0.05
MAX_DIST = 2.0


def map_cells(map_cells: int, seed: int) -> np.ndarray:
    """int8 (n, n) CellState grid: border walls plus seeded 8x8 blocks."""
    rng = np.random.default_rng(seed)
    cells = np.full((map_cells, map_cells), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(max(4, map_cells // 24)):
        cx, cy = rng.integers(8, map_cells - 16, 2)
        cells[cy:cy + 8, cx:cx + 8] = int(CellState.OCCUPIED)
    return cells


def grid_msg(map_size: int, seed: int = 0):
    """The scenario's map as an OccupancyGrid message (0 free, 100
    occupied), its origin placed so that the node's centre-origin
    conversion (`OccupancyMap2D.from_occupancy_grid_msg`) rebuilds
    `build_map`'s cells and origin (0, 0)."""
    from badger_amcl_tpu_torch.node.messages import OccupancyGrid

    cells = map_cells(map_size, seed)
    data = np.where(cells == int(CellState.OCCUPIED), 100, 0).astype(np.int8)
    origin = -(map_size // 2) * RESOLUTION
    return OccupancyGrid(width=map_size, height=map_size, resolution=RESOLUTION,
                         origin_x=origin, origin_y=origin, data=data.ravel())


def laser_scan(omap: OccupancyMap2D, pose, angles: np.ndarray, stamp: float,
               range_max: float = RANGE_MAX, frame_id: str = "laser"):
    """A LaserScan message raycast (sensors.raycast.calc_range) on omap's
    device from a scanner at pose (x, y, yaw) over evenly spaced angles."""
    from badger_amcl_tpu_torch.node.messages import LaserScan
    from badger_amcl_tpu_torch.sensors.raycast import calc_range

    dev = omap.device
    a = torch.as_tensor(np.asarray(angles, np.float32), device=dev)
    x, y, yaw = (torch.full((), float(v), dtype=torch.float32, device=dev) for v in pose)
    ranges = calc_range(omap, x, y, yaw + a, range_max).cpu().numpy()
    return LaserScan(stamp=stamp, frame_id=frame_id, angle_min=float(angles[0]),
                     angle_increment=float(angles[1] - angles[0]), range_min=0.05,
                     range_max=range_max, ranges=ranges)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num) in float32, same arithmetic:
    start * (1 - s) + stop * s with s = iota / (num - 1), endpoint exact."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    div = num - 1
    s = (np.arange(div, dtype=f32) / f32(div)).astype(f32)
    out = f32(start) * (f32(1) - s) + f32(stop) * s
    return np.concatenate([out, np.array([stop], f32)]).astype(f32)


def scan_arrays(n_beams: int):
    """(ranges, angles) float32 numpy arrays of the scenario's scan."""
    angles = linspace_f32(-2.35, 2.35, n_beams)
    ranges = np.clip(np.float32(2.0) + np.float32(0.5) * np.sin(angles * np.float32(3.0)),
                     np.float32(0.2), np.float32(7.9)).astype(np.float32)
    return ranges, angles


def build_map(map_size: int, seed: int = 0, device="cuda",
              model: str = "likelihood_field", range_image_bins: int = 0) -> OccupancyMap2D:
    """The scenario's map with its distance field, the psi texture of
    `model` and the factor texture baked; with range_image_bins > 0 also
    the beam model's range image, baked on `device` (the node bakes it for
    the beam model, node_2d.py:200-207)."""
    omap = OccupancyMap2D.from_cells(map_cells(map_size, seed), RESOLUTION,
                                     device=device).with_distance_field(MAX_DIST)
    scan_params = PlanarScanParams()
    omap = bake_corr_texture(omap, scan_params, RANGE_MAX, model)
    if range_image_bins > 0:
        omap = omap.with_range_image(range_image_bins)
    return bake_factor_texture(omap, scan_params)


def build_scan(n_beams: int, device="cuda") -> PlanarScan:
    ranges, angles = scan_arrays(n_beams)
    return PlanarScan(ranges=torch.as_tensor(ranges, device=device),
                      angles=torch.as_tensor(angles, device=device),
                      range_max=RANGE_MAX)


def build_filter(n_particles: int, seed: int = 0, pose_cov=(0.5, 0.5, 0.1),
                 min_particles=None, pose_mean=(0.0, 0.0, 0.0), device="cuda",
                 pool_lo=(-3.0, -3.0, -3.0), pool_hi=(3.0, 3.0, 3.0)):
    """(params, state, pool): a Gaussian cloud from a generator seeded with
    `seed` and a random-pose pool uniform in [pool_lo, pool_hi) per axis
    from one seeded seed + 1."""
    if min_particles is None:
        min_particles = max(16, n_particles // 50)
    params = PFParams(min_samples=min_particles, max_samples=n_particles)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = pf_filter.init_with_gaussian(
        params, gen, list(pose_mean), torch.diag(torch.tensor(pose_cov)),
        device=device)
    gen_pool = torch.Generator(device=device).manual_seed(seed + 1)
    lo = torch.tensor(pool_lo, dtype=torch.float32, device=device)
    hi = torch.tensor(pool_hi, dtype=torch.float32, device=device)
    pool = torch.rand((n_particles, 3), generator=gen_pool, device=device) * (hi - lo) + lo
    return params, state, pool


def build_setup(n_particles: int, n_beams: int, map_size: int, seed: int = 0,
                pose_cov=(0.5, 0.5, 0.1), min_particles=None,
                pose_mean=(0.0, 0.0, 0.0), device="cuda"):
    """(omap, params, state, scan, scan_params, pool) on `device`, in the
    order of the JAX package's `_build_setup`."""
    omap = build_map(map_size, seed, device)
    params, state, pool = build_filter(n_particles, seed, pose_cov, min_particles,
                                       pose_mean, device)
    return omap, params, state, build_scan(n_beams, device), PlanarScanParams(), pool


FLEET_ODOM_DELTA = (0.05, 0.0, 0.01)  # diff-drive odometry per step
FLEET_ALPHA = 0.05


def build_fleet(n_robots: int, n_particles: int, n_beams: int, seed: int = 0,
                pose_cov=(0.02, 0.02, 0.002), means=None, device="cuda"):
    """(params, states, scans, pools, odom_poses, odom_deltas, alphas) of
    the JAX fleet benchmark: PFParams(min n // 100, max n, a 32 x 32 x 40
    KLD grid, 128 clusters in the statistics), robot means 0.1 N(0, I)
    (or `means`, (R, 3)), clouds N(mean, diag(pose_cov)) from a generator
    seeded with `seed`, the scenario scan for every robot, zero random-pose
    pools, odometry deltas FLEET_ODOM_DELTA from zero poses, alphas 0.05."""
    params = PFParams(min_samples=n_particles // 100, max_samples=n_particles, hist_x=32,
                      hist_y=32, stats_max_clusters=128)
    gen = torch.Generator(device=device).manual_seed(seed)
    if means is None:
        means = 0.1 * torch.randn((n_robots, 3), generator=gen, device=device)
    covs = torch.diag(torch.tensor(pose_cov)).expand(n_robots, 3, 3)
    states = fleet_init(params, means, covs, generator=gen, device=device)
    deltas = torch.tensor(FLEET_ODOM_DELTA, dtype=torch.float32).to(device)
    return (params, states, FleetScan.tile(build_scan(n_beams, device), n_robots),
            torch.zeros((n_robots, n_particles, 3), device=device),
            torch.zeros((n_robots, 3), device=device), deltas.expand(n_robots, 3).contiguous(),
            [FLEET_ALPHA] * 5)


# the 3D scene of benchmarks/parity_tpu.py:run_3d
RESOLUTION_3D = 0.05
MAX_DIST_3D = 0.36
TRUE_POSE_3D = (6.0, 8.0, 0.7)  # x, y, yaw
CLOUD_POINTS = 256  # the 3D default cloud_max_beams


def scene_3d(n_points: int = CLOUD_POINTS, seed: int = 3):
    """(occupied (K, 3) f32 voxel centers, cloud (B, 3) f32 in the base
    frame of TRUE_POSE_3D), the JAX scene's draws in its order."""
    rng = np.random.default_rng(seed)
    occ = []
    zz = np.arange(0.05, 1.0, 0.05)
    for t in np.arange(0.05, 20.0, 0.05):
        for z in zz[::3]:
            occ += [(t, 0.1, z), (t, 19.9, z), (0.1, t, z), (19.9, t, z)]
    for _ in range(14):
        cx, cy = rng.uniform(2, 18, 2)
        for dx in np.arange(-0.2, 0.25, 0.05):
            for dy in np.arange(-0.2, 0.25, 0.05):
                for z in zz[::2]:
                    occ.append((cx + dx, cy + dy, z))
    occ = np.asarray(occ, np.float32)
    true_pose = np.array(TRUE_POSE_3D)
    d = np.linalg.norm(occ[:, :2] - true_pose[:2], axis=1)
    near = occ[(d > 0.5) & (d < 6.0)]
    sel = near[rng.choice(len(near), n_points, replace=False)]
    c, s = np.cos(-true_pose[2]), np.sin(-true_pose[2])
    rel = sel[:, :2] - true_pose[:2]
    base_xy = np.stack([c * rel[:, 0] - s * rel[:, 1],
                        s * rel[:, 0] + c * rel[:, 1]], axis=1)
    cloud = np.concatenate([base_xy, sel[:, 2:3]], axis=1).astype(np.float32)
    return occ, cloud


def build_octomap(occupied: np.ndarray, device="cuda") -> OctoMap3D:
    """The 3D scene's voxel EDT: 20 x 20 x 1 m at 0.05 m, max distance
    0.36 m."""
    return OctoMap3D.from_occupied_points(
        occupied, RESOLUTION_3D, MAX_DIST_3D, metric_min=(0, 0, 0),
        metric_max=(20, 20, 1.0), device=device).with_distance_field()


def build_filter_3d(n_particles: int, seed: int = 0, pose_cov=(0.02, 0.02, 0.002),
                    min_particles=None, device="cuda"):
    """(params, state, pool) for the 3D scene: a Gaussian cloud around
    TRUE_POSE_3D and a random-pose pool over the map's footprint."""
    return build_filter(n_particles, seed, pose_cov, min_particles, TRUE_POSE_3D, device,
                        pool_lo=(0.0, 0.0, -np.pi), pool_hi=(20.0, 20.0, np.pi))


def build_setup_3d(n_particles: int, n_points: int = CLOUD_POINTS, seed: int = 0,
                   pose_cov=(0.02, 0.02, 0.002), min_particles=None, device="cuda"):
    """(omap, params, state, cloud, pc_params, pool) on `device`: the 3D
    scene and `build_filter_3d`'s filter."""
    occ, cloud = scene_3d(n_points)
    params, state, pool = build_filter_3d(n_particles, seed, pose_cov, min_particles,
                                          device)
    return (build_octomap(occ, device), params, state,
            torch.as_tensor(cloud, device=device), PointCloudParams(), pool)
