"""Batched Bresenham raycasting against the occupancy grid (counterpart of
badger_amcl_tpu.sensors.raycast).

Reproduces `OccupancyMap::calcRange` (occupancy_map.cpp:257-364) exactly:
unknown and out-of-bounds cells block, the range is the Euclidean cell
distance times the resolution, the start cell is tested before stepping,
and coincident endpoints return max_range. The whole ray bundle advances
in lockstep; finished rays are frozen (raycast.py:97-100), so the loop runs
a fixed count computed on the host from max_range / resolution instead of
reading `any(~done)` back every cell step.
"""

from __future__ import annotations

import math

import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState


def calc_range(omap, ox, oy, oa, max_range: float) -> torch.Tensor:
    """Batched calcRange: ox/oy/oa (broadcastable f32 tensors) -> ranges of
    the broadcast shape, in meters."""
    ox, oy, oa = torch.broadcast_tensors(ox.to(torch.float32), oy.to(torch.float32),
                                         oa.to(torch.float32))
    rmax = float(max_range)
    x0, y0 = omap.cells_of(ox, oy)
    x1, y1 = omap.cells_of(ox + rmax * torch.cos(oa), oy + rmax * torch.sin(oa))

    same = (x0 == x1) & (y0 == y1)
    steep = (y1 - y0).abs() > (x1 - x0).abs()
    # swap into the driving axis (occupancy_map.cpp:287-296)
    sx0 = torch.where(steep, y0, x0)
    sy0 = torch.where(steep, x0, y0)
    sx1 = torch.where(steep, y1, x1)
    sy1 = torch.where(steep, x1, y1)
    deltax = (sx1 - sx0).abs()
    deltay = (sy1 - sy0).abs()
    xstep = torch.where(sx0 < sx1, 1, -1).to(torch.int32)
    ystep = torch.where(sy0 < sy1, 1, -1).to(torch.int32)
    cells = omap.cells.reshape(-1)

    def blocked(x, y):
        """Cell test in swapped coordinates: (i, j) = (y, x) if steep."""
        i = torch.where(steep, y, x)
        j = torch.where(steep, x, y)
        state = cells[omap.flat_index(i, j)]
        return ~omap.in_bounds(i, j) | (state != int(CellState.FREE))

    def dist(x, y):
        # an exact integer square; its float64 root rounded to f32 is the
        # correctly rounded f32 root (PyTorch's vectorized f32 sqrt on the
        # CPU is not, the JAX package's is)
        dx = x - sx0
        dy = y - sy0
        d2 = (dx * dx + dy * dy).to(torch.float64)
        return torch.sqrt(d2).to(torch.float32) * omap.resolution

    # start-cell test (occupancy_map.cpp:315-332)
    hit0 = blocked(sx0, sy0) & ~same
    result = torch.where(same | ~hit0, rmax, dist(sx0, sy0))
    done = same | hit0
    x, y = sx0, sy0
    err = torch.zeros_like(sx0)
    # a ray marks itself done at x == sx1 + xstep, deltax + 2 steps in at
    # the latest; deltax <= floor(max_range / res) + 1, plus one cell of f32
    # slack in the endpoint
    for _ in range(math.ceil(rmax / omap.resolution) + 4):
        done = done | (x == sx1 + xstep)  # loop guard `while (x != x1 + xstep)`
        nx = x + xstep
        nerr = err + deltay
        bump = 2 * nerr >= deltax
        ny = torch.where(bump, y + ystep, y)
        nerr = torch.where(bump, nerr - deltax, nerr)
        hit = blocked(nx, ny) & ~done
        result = torch.where(hit, dist(nx, ny), result)
        done = done | hit
        x = torch.where(done, x, nx)
        y = torch.where(done, y, ny)
        err = torch.where(done, err, nerr)
    return result
