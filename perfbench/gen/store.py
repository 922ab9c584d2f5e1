"""The seeded store: a 100 x 60 m retail floor of gondola rows, as a ROS
occupancy grid (2D) and as occupied voxels (3D).

A copy of the generators that `chip_smoke.py` runs for its map set-up
(`store_gondolas`, `store_grid`, `store_voxels`), kept here so that the
benchmark's data does not change when the smoke test does. Sizes are in
cells of the map's resolution (0.05 m in both configurations).
"""

from __future__ import annotations

import numpy as np

MARGIN = 20  # unknown cells outside the 2D store's walls
SHELF_VOXELS = 36  # gondola faces 1.8 m high


def gondolas(w: int, h: int, seed: int) -> list:
    """Gondola rows of the plan as (x0, x1, y0, y1) half-open boxes in
    cells: rows along x 1.2 m deep with 2 m aisles, behind a 6 m front
    area, split by 3 m cross aisles every ~19 m (seeded lengths)."""
    rng = np.random.default_rng(seed)
    m, rows = MARGIN, []
    y = m + 120
    while y + 24 < h - m - 60:
        x = m + 100
        while x < w - m - 160:
            x1 = min(x + int(rng.integers(340, 420)), w - m - 100)
            rows.append((x, x1, y, y + 24))
            x = x1 + 60
        y += 24 + 40
    return rows


def grid(w: int, h: int, seed: int) -> np.ndarray:
    """The (h, w) int8 ROS occupancy grid (0 free, 100 occupied, -1
    unknown), as a lidar map shows the store: 2-cell outer walls MARGIN
    cells inside the grid, unknown outside them; each gondola's faces
    occupied and its inside unknown; 40 pallets of 1 m in the front area;
    single-cell clutter on 0.02% of the free cells."""
    rng = np.random.default_rng(seed + 1)
    m = MARGIN
    g = np.full((h, w), -1, np.int8)
    g[m:h - m, m:w - m] = 0
    g[m:m + 2, m:w - m] = g[h - m - 2:h - m, m:w - m] = 100
    g[m:h - m, m:m + 2] = g[m:h - m, w - m - 2:w - m] = 100
    for x0, x1, y0, y1 in gondolas(w, h, seed):
        g[y0:y1, x0:x1] = -1
        g[y0, x0:x1] = g[y1 - 1, x0:x1] = g[y0:y1, x0] = g[y0:y1, x1 - 1] = 100
    for _ in range(40):
        px, py = rng.integers(m + 10, w - m - 30), rng.integers(m + 10, m + 100)
        g[py:py + 20, px:px + 20] = 100
    g[(g == 0) & (rng.random((h, w)) < 2e-4)] = 100
    return g


def voxels(nx: int, ny: int, nz: int, seed: int) -> np.ndarray:
    """(K, 3) int64 occupied voxel cells of the store volume: the floor
    plane, the four outer walls to full height at the volume's edges, and
    the gondolas' faces to SHELF_VOXELS with seeded gaps (a missing face
    column, 10%)."""
    rng = np.random.default_rng(seed + 2)
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    parts = [np.stack([gx.ravel(), gy.ravel(), np.zeros(nx * ny, np.int64)], axis=1)]
    rim = (gx == 0) | (gx == nx - 1) | (gy == 0) | (gy == ny - 1)
    faces = np.zeros((nx, ny), bool)
    for x0, x1, y0, y1 in gondolas(nx, ny, seed):
        faces[x0:x1, y0] = faces[x0:x1, y1 - 1] = faces[x0, y0:y1] = faces[x1 - 1, y0:y1] = True
    faces &= rng.random((nx, ny)) >= 0.1
    for mask, top in ((rim, nz), (faces, min(SHELF_VOXELS, nz))):
        xs, ys = np.nonzero(mask)
        zs = np.arange(1, top)
        parts.append(np.stack([np.repeat(xs, len(zs)), np.repeat(ys, len(zs)),
                               np.tile(zs, len(xs))], axis=1))
    return np.concatenate(parts)

