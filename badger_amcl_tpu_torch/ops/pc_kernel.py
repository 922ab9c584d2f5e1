"""Voxel distance at every (cloud point, particle) pair for converged and
tracking clouds (counterpart of badger_amcl_tpu.ops.pc_kernel).

The particle transform is a z-rotation plus a planar translation
(getMapCloud, point_cloud_scanner.cpp:231-248), so point b's z-slab is the
same for every particle and its (x, y) cell is the TPU kernel's
floor(e * inv_res + 0.5) - min with e = p + R(theta) q (pc_kernel.py:66-72).
The distance is the uint8 ratio at that voxel times max_distance_ratio,
255 off the map (:90, :221); a point outside the z band reads
max_distance_to_object (distance_at's convention; the dispatch never sends
such a cloud here, `window_origins` folds the band into `fits`).

`pc_distances` is the kernel wrapper: CUDA tensors launch
csrc/pc_distances.cu, CPU tensors run `pc_distances_plain`. The TPU
kernel's per-point 64 x 256 windows and one-hot matmuls are not ported (a
GPU gathers directly); `tex_fits` and `window_origins` are kept as the
dispatch predicate, so the port takes the windowed arm exactly where the
JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import _build

WIN_ROWS = 64
WIN_COLS = 256
LOAD_R = WIN_ROWS + 32
MAX_TEX_BYTES = 10 * 1024 * 1024


def tex_fits(omap) -> bool:
    """The JAX package's static gate: z-major texture within its VMEM budget
    and at least one window wide (pc_kernel.py:96-104)."""
    nx, ny, nz = omap.size
    return nz * ny * nx <= MAX_TEX_BYTES and ny >= LOAD_R and nx >= WIN_COLS


def _inv_res(omap) -> float:
    """1 / resolution rounded to f32, as every kernel arm multiplies by it."""
    return float(np.float32(1.0 / omap.resolution))


def window_origins(omap, points_base, poses):
    """Per-point window origins (row0, col0), z-slabs and the fits flag of
    the TPU kernel's windows, with its (32, 128) alignment
    (pc_kernel.py:107-144). fits is a 0-dim bool tensor."""
    inv_res = _inv_res(omap)
    nx, ny, nz = omap.size
    c = torch.cos(poses[:, 2])[:, None]
    s = torch.sin(poses[:, 2])[:, None]
    qx = points_base[None, :, 0]
    qy = points_base[None, :, 1]
    ex = poses[:, 0][:, None] + c * qx - s * qy
    ey = poses[:, 1][:, None] + s * qx + c * qy
    ci = torch.floor(ex * inv_res + 0.5).to(torch.int32) - omap.min_cells[0]
    cj = torch.floor(ey * inv_res + 0.5).to(torch.int32) - omap.min_cells[1]
    inb = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny)
    big = 1 << 30
    ci_min = torch.where(inb, ci, big).min(dim=0).values
    ci_max = torch.where(inb, ci, -big).max(dim=0).values
    cj_min = torch.where(inb, cj, big).min(dim=0).values
    cj_max = torch.where(inb, cj, -big).max(dim=0).values
    row0 = torch.where(cj_min == big, 0, cj_min).clamp(0, max(ny - LOAD_R, 0)) & ~31
    col0 = torch.where(ci_min == big, 0, ci_min).clamp(0, max(nx - WIN_COLS, 0)) & ~127
    fits = torch.all(
        ((ci_max - col0 < WIN_COLS) & (ci_min - col0 >= 0)
         & (cj_max - row0 < WIN_ROWS) & (cj_min - row0 >= 0))
        # all-out-of-bounds points have inverted extrema: they fit
        | ((ci_min == big) & (cj_min == big)))
    kz = point_slabs(omap, points_base)
    slab_ok = torch.all((kz >= 0) & (kz < nz))
    return row0.to(torch.int32), col0.to(torch.int32), kz, fits & slab_ok


def point_slabs(omap, points_base) -> torch.Tensor:
    """(B,) int32 texture-local z-slab of each point."""
    kz = torch.floor(points_base[:, 2] * _inv_res(omap) + 0.5).to(torch.int32)
    return kz - omap.min_cells[2]


def pc_distances_plain(omap, points_base, poses) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, M) f32 distances in meters."""
    inv_res = _inv_res(omap)
    nx, ny, nz = omap.size
    c = torch.cos(poses[:, 2])[None, :]
    s = torch.sin(poses[:, 2])[None, :]
    qx = points_base[:, 0][:, None]
    qy = points_base[:, 1][:, None]
    ex = poses[:, 0][None, :] + c * qx - s * qy
    ey = poses[:, 1][None, :] + s * qx + c * qy
    ci = torch.floor(ex * inv_res + 0.5).to(torch.int32) - omap.min_cells[0]
    cj = torch.floor(ey * inv_res + 0.5).to(torch.int32) - omap.min_cells[1]
    kz = point_slabs(omap, points_base)[:, None].expand_as(ci)
    ratio = omap.tex_zyx.reshape(-1)[omap.flat_index(ci, cj, kz)].to(torch.float32)
    inmap = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny)
    d = torch.where(inmap, ratio, 255.0) * float(np.float32(omap.max_distance_ratio))
    return torch.where((kz >= 0) & (kz < nz), d, omap.max_distance_to_object)


def pc_distances(omap, points_base, poses) -> torch.Tensor:
    """(B, M) f32 distances (meters) at every transformed cloud point."""
    if omap.tex_zyx is None:
        raise ValueError("the map has no distance field (with_distance_field)")
    if poses.dim() != 2 or poses.shape[1] != 3 or poses.dtype != torch.float32:
        raise ValueError("poses must be (M, 3) float32")
    if points_base.dim() != 2 or points_base.shape[1] != 3 \
            or points_base.dtype != torch.float32:
        raise ValueError("points_base must be (B, 3) float32")
    if poses.device.type != "cuda":
        return pc_distances_plain(omap, points_base, poses)
    for t in (points_base, omap.tex_zyx):
        if t.device != poses.device:
            raise ValueError("all inputs must be on one device")
    m, b = poses.shape[0], points_base.shape[0]
    out = torch.empty((b, m), dtype=torch.float32, device=poses.device)
    if m == 0 or b == 0:
        return out
    nx, ny, nz = omap.size
    poses, points_base = poses.contiguous(), points_base.contiguous()
    code = _build.lib().pc_distances_launch(
        omap.tex_zyx.contiguous().data_ptr(), nx, ny, nz, poses.data_ptr(), m,
        points_base.data_ptr(), b, _inv_res(omap), omap.min_cells[0],
        omap.min_cells[1], omap.min_cells[2], omap.max_distance_ratio,
        omap.max_distance_to_object, out.data_ptr(), _build.stream_ptr(poses.device))
    _build.check(code, "pc_distances")
    pc_distances.launches += 1
    return out


pc_distances.launches = 0
