"""The maps' distance fields at map receipt (counterpart of the JAX
package's native host hook `edt_cells`, badger_amcl_tpu/utils/native.py:68,
with the capping of badger_amcl_tpu/maps/edt.py:103-124 and the
quantization of badger_amcl_tpu/maps/octomap_3d.py:136-141).

Kernel wrappers (CUDA tensors launch csrc/edt.cu, CPU tensors run the plain
version beside each):
- `capped_field_2d`: the f32 (H, W) capped distance field of an int8
  CellState grid, `d <= cell_radius ? d * resolution : max_dist` with
  cell_radius = floor(max_dist / resolution);
- `voxel_texture_3d`: the uint8 texture floor(min(d * resolution, max) /
  max * 255) of a uint8 occupancy volume, in the volume's own layout (the
  transform treats every axis alike; the maps pass (nz, ny, nx)).

Both compute what the maps read, not the uncapped EDT: a windowed minimum
of g(v) + (q - v)^2 along each axis in turn, over |q - v| <= R, in int32,
values above R^2 replaced by FAR after each pass. A cell whose true
squared distance is at most R^2 gets it exactly, any other a value above
R^2 (csrc/edt.cu says why), so with R chosen by `window_2d` / `window_3d`
the results equal the numpy exact EDT's (maps/edt.py) bit for bit. The
last pass finishes in float64, each operation rounded alone, as numpy
does.
"""

from __future__ import annotations

import math

import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils.numerics import fdiv

FAR = 1 << 30  # a cell with no source within the window
MAX_WINDOW = 16384  # FAR + R^2 stays below 2^31


def window_2d(resolution: float, max_dist: float) -> int:
    """cell_radius = floor(max_dist / resolution) of the 2D field, which is
    also its window: every cell beyond it reads max_dist."""
    if max_dist <= 0.0:
        raise ValueError("max_dist must be > 0")
    cell_radius = int(math.floor(max_dist / resolution))
    _check_window(cell_radius)
    return cell_radius


def window_3d(resolution: float, max_dist: float) -> int:
    """R of the 3D texture: floor(max / res) + 1, raised while R * res <
    max, so every cell beyond R reads 255 (its d * res rounds to >= max)."""
    if max_dist <= 0.0:
        raise ValueError("max_dist must be > 0")
    r = int(math.floor(max_dist / resolution)) + 1
    while r * resolution < max_dist:
        r += 1
    _check_window(r)
    return r


def _check_window(r: int) -> None:
    if r > MAX_WINDOW:
        raise ValueError(f"a window of {r} cells exceeds {MAX_WINDOW} (max_dist / resolution)")


def _window_min(g: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """min over |o| <= r of g shifted by o along dim, plus o^2; values
    above r^2 set to FAR."""
    n = g.shape[dim]
    out = g.clone()
    for o in range(1, min(r, n - 1) + 1):
        hi = out.narrow(dim, o, n - o)
        hi.copy_(torch.minimum(hi, g.narrow(dim, 0, n - o) + o * o))
        lo = out.narrow(dim, 0, n - o)
        lo.copy_(torch.minimum(lo, g.narrow(dim, o, n - o) + o * o))
    return torch.where(out > r * r, FAR, out)


def _squared_distances(source: torch.Tensor, r: int) -> torch.Tensor:
    """int32 windowed squared distances of a bool source mask: the passes
    from the first axis to the last, as the kernel runs them."""
    g = torch.where(source, 0, FAR).to(torch.int32)
    for dim in range(source.dim()):
        g = _window_min(g, dim, r)
    return g


def _check_2d(cells):
    if cells.dim() != 2 or cells.dtype != torch.int8:
        raise ValueError("cells must be an int8 (H, W) CellState grid")


def _check_3d(occ):
    if occ.dim() != 3 or occ.dtype != torch.uint8:
        raise ValueError("occ must be a uint8 (a, b, c) occupancy volume")


def capped_field_2d_plain(cells: torch.Tensor, resolution: float,
                          max_dist: float) -> torch.Tensor:
    """Plain PyTorch version of the 2D kernel: f32 (H, W)."""
    _check_2d(cells)
    cell_radius = window_2d(resolution, max_dist)
    d = torch.sqrt(_squared_distances(cells == 1, cell_radius).to(torch.float64))
    return torch.where(d <= cell_radius, d * resolution, max_dist).to(torch.float32)


def capped_field_2d(cells: torch.Tensor, resolution: float, max_dist: float) -> torch.Tensor:
    """The capped distance field (meters, f32 (H, W)) of an int8 CellState
    grid, OCCUPIED (1) cells the sources: two launches on CUDA tensors."""
    _check_2d(cells)
    if cells.device.type != "cuda":
        return capped_field_2d_plain(cells, resolution, max_dist)
    cell_radius = window_2d(resolution, max_dist)
    h, w = cells.shape
    out = torch.empty((h, w), dtype=torch.float32, device=cells.device)
    if out.numel() == 0:
        return out
    cells = cells.contiguous()
    scratch = torch.empty((h, w), dtype=torch.int32, device=cells.device)
    code = _build.lib().edt_2d_launch(
        cells.data_ptr(), h, w, cell_radius, float(resolution), float(max_dist),
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(cells.device))
    _build.check(code, "capped_field_2d")
    capped_field_2d.launches += 1
    return out


capped_field_2d.launches = 0


def voxel_texture_3d_plain(occ: torch.Tensor, resolution: float,
                           max_dist: float) -> torch.Tensor:
    """Plain PyTorch version of the 3D kernel: uint8, occ's shape."""
    _check_3d(occ)
    r = window_3d(resolution, max_dist)
    d = torch.sqrt(_squared_distances(occ != 0, r).to(torch.float64))
    dm = torch.clamp(d * resolution, max=max_dist)
    return torch.floor(fdiv(dm, max_dist) * 255.0).to(torch.uint8)


def voxel_texture_3d(occ: torch.Tensor, resolution: float, max_dist: float) -> torch.Tensor:
    """The uint8 distance texture floor(min(d * res, max) / max * 255) of a
    uint8 occupancy volume (nonzero = occupied), in its layout: three
    launches on CUDA tensors."""
    _check_3d(occ)
    if occ.device.type != "cuda":
        return voxel_texture_3d_plain(occ, resolution, max_dist)
    r = window_3d(resolution, max_dist)
    a, b, c = occ.shape
    out = torch.empty((a, b, c), dtype=torch.uint8, device=occ.device)
    if out.numel() == 0:
        return out
    occ = occ.contiguous()
    scratch = torch.empty((2, a, b, c), dtype=torch.int32, device=occ.device)
    code = _build.lib().edt_3d_launch(
        occ.data_ptr(), a, b, c, r, float(resolution), float(max_dist),
        scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(),
        _build.stream_ptr(occ.device))
    _build.check(code, "voxel_texture_3d")
    voxel_texture_3d.launches += 1
    return out


voxel_texture_3d.launches = 0
