"""The sensors: a planar laser and a multi-ring lidar, raycast on the card
into the store as each node's map holds it.

Rays are marched at half a cell: the first sample inside an occupied cell
ends the ray, and the range gets seeded Gaussian noise. Both follow the
conventions of the map each node builds from its message, so a reading
lies on what that node's map holds:

- 2D: the node supersamples the grid by `scale`; its cell I covers
  [(I - 0.5) r, (I + 0.5) r) at r = resolution / scale (centre origin at
  the world origin here), so grid cell i covers x with
  floor(x / resolution + 0.5 / scale) = i.
- 3D: voxel k covers [(k - 0.5) res, (k + 0.5) res) on each axis (world =
  cell * res). Every column of the store is filled from the floor to its
  top, so a sample at height z blocks where z < (top + 0.5) res; the floor
  is a column of top 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _first_hit(blocked: torch.Tensor):
    """(index of the first True along the last axis, whether there is one)."""
    hit = blocked.any(dim=-1)
    return blocked.to(torch.uint8).argmax(dim=-1), hit


def planar_ranges(occupied: torch.Tensor, resolution: float, scale: int, poses: np.ndarray,
                  angles: np.ndarray, range_max: float, noise: float,
                  generator: torch.Generator, chunk: int = 64) -> np.ndarray:
    """(N, B) float32 ranges of a laser at `poses` (N, 3) with beam
    `angles` (B,) in its frame; no return within range_max reads
    range_max. occupied: (H, W) bool on the card, grid cells [j, i]."""
    dev = occupied.device
    h, w = occupied.shape
    step = resolution / 2
    ts = torch.arange(1, int(math.ceil(range_max / step)) + 1, device=dev,
                      dtype=torch.float64) * step
    ang = torch.as_tensor(angles, dtype=torch.float64, device=dev)
    off = 0.5 / scale
    out = []
    for s in range(0, len(poses), chunk):
        p = torch.as_tensor(poses[s:s + chunk], dtype=torch.float64, device=dev)
        th = p[:, 2:3] + ang[None]
        cx = (p[:, 0, None, None] + torch.cos(th)[..., None] * ts) / resolution + off
        cy = (p[:, 1, None, None] + torch.sin(th)[..., None] * ts) / resolution + off
        i, j = torch.floor(cx).long(), torch.floor(cy).long()
        inside = (i >= 0) & (i < w) & (j >= 0) & (j < h)
        blocked = occupied[j.clamp(0, h - 1), i.clamp(0, w - 1)] & inside
        first, hit = _first_hit(blocked)
        r = torch.where(hit, ts[first], range_max)
        r = r + noise * torch.randn(r.shape, generator=generator, device=dev,
                                    dtype=torch.float64)
        out.append(torch.where(hit, r.clamp(0.0, range_max), range_max).float())
    return torch.cat(out).cpu().numpy()


def lidar_clouds(tops: torch.Tensor, nz: int, resolution: float, poses: np.ndarray,
                 height: float, elevations: np.ndarray, azimuths: np.ndarray,
                 range_max: float, noise: float, generator: torch.Generator,
                 chunk: int = 8) -> list:
    """One (K_n, 3) float32 cloud per pose, in the lidar's frame (mounted
    `height` above the robot's footprint, level): every (elevation,
    azimuth) ray that hits the volume within range_max, the others
    dropped. tops: (nx, ny) int32 column tops on the card."""
    dev = tops.device
    f32 = torch.float32
    nx, ny = tops.shape
    top_z = (tops.to(f32) + 0.5) * resolution  # a sample below it is blocked
    ceiling = (nz - 0.5) * resolution
    step = resolution / 2
    n_s = int(math.ceil(range_max / step))
    ts = torch.arange(1, n_s + 1, device=dev, dtype=f32) * step  # along the ray
    el = torch.as_tensor(elevations, dtype=f32, device=dev)
    az = torch.as_tensor(azimuths, dtype=f32, device=dev)
    plan = torch.cos(el)[:, None] * ts[None]  # (E, S) horizontal distance
    rise = torch.sin(el)[:, None] * ts[None]  # (E, S)
    out = []
    for s in range(0, len(poses), chunk):
        p = torch.as_tensor(poses[s:s + chunk], dtype=f32, device=dev)
        yaw = p[:, 2:3] + az[None]  # (n, A)
        c, sn = torch.cos(yaw), torch.sin(yaw)
        x = p[:, 0, None, None, None] + c[:, None, :, None] * plan[None, :, None, :]
        y = p[:, 1, None, None, None] + sn[:, None, :, None] * plan[None, :, None, :]
        z = height + rise[None, :, None, :]
        i = torch.floor(x / resolution + 0.5).int()
        j = torch.floor(y / resolution + 0.5).int()
        inside = (i >= 0) & (i < nx) & (j >= 0) & (j < ny) & (z < ceiling)
        flat = i.clamp(0, nx - 1).long() * ny + j.clamp(0, ny - 1)
        blocked = (z < top_z.view(-1)[flat]) & inside
        first, hit = _first_hit(blocked)  # (n, E, A)
        t = ts[first] + noise * torch.randn(first.shape, generator=generator, device=dev)
        d = torch.stack([torch.cos(el)[:, None] * torch.cos(az)[None],
                         torch.cos(el)[:, None] * torch.sin(az)[None],
                         torch.sin(el)[:, None].expand(-1, len(azimuths))], dim=-1)
        pts = t[..., None] * d[None]
        for k in range(pts.shape[0]):
            out.append(pts[k][hit[k]])
    return [c.cpu().numpy() for c in out]
