"""Seeded scenario builder: the port's JAX-free twin of the JAX package's
`__graft_entry__._build_setup`.

The map comes from the same `np.random.default_rng(seed)` recipe, so its
cells are bit-identical, and the scan follows the same formulas (the
angles reproduce jnp.linspace's f32 arithmetic). The psi and factor
textures are baked as the JAX setup bakes them. Initial poses and the
random-pose pool come from torch.Generators seeded with seed and seed + 1,
so they differ from the JAX package's draws in value, not in law.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf.types import PFParams
from badger_amcl_tpu_torch.sensors.planar import (
    PlanarScan, PlanarScanParams, bake_corr_texture, bake_factor_texture,
)

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


def build_map(map_size: int, seed: int = 0, device="cpu") -> OccupancyMap2D:
    """The scenario's map with its distance field and baked textures."""
    omap = OccupancyMap2D.from_cells(map_cells(map_size, seed), RESOLUTION,
                                     device=device).with_distance_field(MAX_DIST)
    scan_params = PlanarScanParams()
    omap = bake_corr_texture(omap, scan_params, RANGE_MAX, "likelihood_field")
    return bake_factor_texture(omap, scan_params)


def build_scan(n_beams: int, device="cpu") -> PlanarScan:
    ranges, angles = scan_arrays(n_beams)
    return PlanarScan(ranges=torch.as_tensor(ranges, device=device),
                      angles=torch.as_tensor(angles, device=device),
                      range_max=RANGE_MAX)


def build_filter(n_particles: int, seed: int = 0, pose_cov=(0.5, 0.5, 0.1),
                 min_particles=None, pose_mean=(0.0, 0.0, 0.0), device="cpu"):
    """(params, state, pool): a Gaussian cloud from a generator seeded with
    `seed` and a uniform [-3, 3) random-pose pool from one seeded seed + 1."""
    if min_particles is None:
        min_particles = max(16, n_particles // 50)
    params = PFParams(min_samples=min_particles, max_samples=n_particles)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = pf_filter.init_with_gaussian(
        params, gen, list(pose_mean), torch.diag(torch.tensor(pose_cov)),
        device=device)
    gen_pool = torch.Generator(device=device).manual_seed(seed + 1)
    pool = torch.rand((n_particles, 3), generator=gen_pool, device=device) * 6.0 - 3.0
    return params, state, pool


def build_setup(n_particles: int, n_beams: int, map_size: int, seed: int = 0,
                pose_cov=(0.5, 0.5, 0.1), min_particles=None,
                pose_mean=(0.0, 0.0, 0.0), device="cpu"):
    """(omap, params, state, scan, scan_params, pool) on `device`, in the
    order of the JAX package's `_build_setup`."""
    omap = build_map(map_size, seed, device)
    params, state, pool = build_filter(n_particles, seed, pose_cov, min_particles,
                                       pose_mean, device)
    return omap, params, state, build_scan(n_beams, device), PlanarScanParams(), pool
