"""Voxel distances at the transformed cloud points for converged and
tracking clouds (counterpart of badger_amcl_tpu.ops.pc_kernel).

The particle transform is a z-rotation plus a planar translation
(getMapCloud, point_cloud_scanner.cpp:231-248), so point b's z-slab is the
same for every particle and its (x, y) cell is the TPU kernel's
floor(e * inv_res + 0.5) - min with e = p + R(theta) q (pc_kernel.py:66-72).
The distance is the uint8 ratio at that voxel times max_distance_ratio,
255 off the map (:90, :221); a point outside the z band reads
max_distance_to_object (distance_at's convention; the dispatch never sends
such a cloud here, `window_origins` folds the band into `fits`).

Kernel wrappers (CUDA tensors launch csrc/pc_distances.cu, CPU tensors run
the plain version beside each):
- `pc_term_sums`: per particle the sum over the points of a `PCTerm` of
  the distance, (M,), fused: nothing (B, M) is materialized (the windowed
  arm of `sensors.point_cloud`);
- `pc_extents`: the window prepass's per-point extents of the in-map
  endpoint cells, which `window_finish` turns into the TPU kernel's window
  origins and its fits flag (`window_origins`, the dispatch predicate);
- `pc_distances`: the (B, M) distances, the counterpart of the JAX
  package's `windowed_distances` / `pc_distances_t` (no main path of the
  port launches it).

The TPU kernel's per-point 64 x 256 windows and one-hot matmuls are not
ported (a GPU gathers directly); `tex_fits` and `window_origins` are kept
as the dispatch predicate, so the port takes the windowed arm exactly
where the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils.numerics import fdiv

WIN_ROWS = 64
WIN_COLS = 256
LOAD_R = WIN_ROWS + 32
MAX_TEX_BYTES = 10 * 1024 * 1024
BIG = 1 << 30  # the extent of a point without an in-map endpoint


def tex_fits(omap) -> bool:
    """The JAX package's static gate: z-major texture within its VMEM budget
    and at least one window wide (pc_kernel.py:96-104)."""
    nx, ny, nz = omap.size
    return nz * ny * nx <= MAX_TEX_BYTES and ny >= LOAD_R and nx >= WIN_COLS


def _inv_res(omap) -> float:
    """1 / resolution rounded to f32, as every kernel arm multiplies by it."""
    return float(np.float32(1.0 / omap.resolution))


def point_slabs(omap, points_base) -> torch.Tensor:
    """(B,) int32 texture-local z-slab of each point."""
    kz = torch.floor(points_base[:, 2] * _inv_res(omap) + 0.5).to(torch.int32)
    return kz - omap.min_cells[2]


@dataclasses.dataclass(frozen=True)
class PCTerm:
    """Point-cloud model term of a distance z: pz = z_hit exp(-z^2 / denom)
    + zr, cubed for likelihood_field, as is for the Gompertz model
    (point_cloud.py:90-100)."""

    z_hit: float
    denom: float
    zr: float
    cube: bool

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        pz = self.z_hit * torch.exp(fdiv(-(z * z), self.denom)) + self.zr
        return pz * pz * pz if self.cube else pz


@functools.lru_cache(maxsize=64)
def term_table(term: PCTerm, max_ratio: float, max_dist: float,
               device: torch.device) -> torch.Tensor:
    """(257,) f32: `term` at z = q * float32(max_ratio) for the uint8
    ratios q = 0..255 (255 is also the off-map value), then at z = max_dist
    (a point outside the z band): the plain version's own expression on the
    same device, so a lookup gives its term bit for bit. Cached per (term,
    max_ratio, max_dist, device)."""
    q = torch.arange(256, dtype=torch.float32, device=device)
    z = torch.cat([q * float(np.float32(max_ratio)),
                   torch.full((1,), max_dist, dtype=torch.float32, device=device)])
    return term(z).contiguous()


def _check_inputs(omap, points_base, poses):
    if omap.tex_zyx is None:
        raise ValueError("the map has no distance field (with_distance_field)")
    if poses.dim() != 2 or poses.shape[1] != 3 or poses.dtype != torch.float32:
        raise ValueError("poses must be (M, 3) float32")
    if points_base.dim() != 2 or points_base.shape[1] != 3 \
            or points_base.dtype != torch.float32:
        raise ValueError("points_base must be (B, 3) float32")
    if poses.device.type == "cuda":
        for t in (points_base, omap.tex_zyx):
            if t.device != poses.device:
                raise ValueError("all inputs must be on one device")


def _cells(omap, points_base, poses):
    """(B, M) int32 texture-local cells (ci, cj) of every transformed point."""
    inv_res = _inv_res(omap)
    c = torch.cos(poses[:, 2])[None, :]
    s = torch.sin(poses[:, 2])[None, :]
    qx = points_base[:, 0][:, None]
    qy = points_base[:, 1][:, None]
    ex = poses[:, 0][None, :] + c * qx - s * qy
    ey = poses[:, 1][None, :] + s * qx + c * qy
    ci = torch.floor(ex * inv_res + 0.5).to(torch.int32) - omap.min_cells[0]
    cj = torch.floor(ey * inv_res + 0.5).to(torch.int32) - omap.min_cells[1]
    return ci, cj


def _on_map(omap, ci, cj):
    nx, ny, _ = omap.size
    return (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny)


def pc_extents_plain(omap, points_base, poses):
    """Plain PyTorch version of the prepass kernel: (4, B) int32 rows
    ci_min, ci_max, cj_min, cj_max over each point's in-map endpoint cells,
    +-BIG for a point with none (pc_kernel.py:108-124)."""
    ci, cj = _cells(omap, points_base, poses)
    inb = _on_map(omap, ci, cj)
    return torch.stack([torch.where(inb, ci, BIG).min(dim=1).values,
                        torch.where(inb, ci, -BIG).max(dim=1).values,
                        torch.where(inb, cj, BIG).min(dim=1).values,
                        torch.where(inb, cj, -BIG).max(dim=1).values]).to(torch.int32)


def pc_extents(omap, points_base, poses):
    """The per-point extents (4, B) int32 of `pc_extents_plain`: one call of
    the CUDA prepass (two launches) on CUDA tensors."""
    _check_inputs(omap, points_base, poses)
    if poses.device.type != "cuda":
        return pc_extents_plain(omap, points_base, poses)
    m, b = poses.shape[0], points_base.shape[0]
    ext = torch.empty((4, b), dtype=torch.int32, device=poses.device)
    if b == 0:
        return ext
    nx, ny, _ = omap.size
    poses, points_base = poses.contiguous(), points_base.contiguous()
    code = _build.lib().pc_extents_launch(
        poses.data_ptr(), m, points_base.data_ptr(), b, nx, ny, _inv_res(omap),
        omap.min_cells[0], omap.min_cells[1], ext.data_ptr(), _build.stream_ptr(poses.device))
    _build.check(code, "pc_extents")
    pc_extents.launches += 1
    return ext


pc_extents.launches = 0


def window_finish(omap, ext, kz):
    """Per-point window origins (row0, col0), the z-slabs `kz` and the fits
    flag of the TPU kernel's windows from the extents, with its (32, 128)
    alignment (pc_kernel.py:125-144): origins clamped into the texture,
    then fits judged on the usable window; a point without an in-map cell
    fits; every slab must lie in the z band. fits is a 0-dim bool tensor."""
    nx, ny, nz = omap.size
    ci_min, ci_max, cj_min, cj_max = ext.unbind(0)
    row0 = torch.where(cj_min == BIG, 0, cj_min).clamp(0, max(ny - LOAD_R, 0)) & ~31
    col0 = torch.where(ci_min == BIG, 0, ci_min).clamp(0, max(nx - WIN_COLS, 0)) & ~127
    fits = torch.all(
        ((ci_max - col0 < WIN_COLS) & (ci_min - col0 >= 0)
         & (cj_max - row0 < WIN_ROWS) & (cj_min - row0 >= 0))
        | ((ci_min == BIG) & (cj_min == BIG)))
    slab_ok = torch.all((kz >= 0) & (kz < nz))
    return row0.to(torch.int32), col0.to(torch.int32), kz, fits & slab_ok


def window_origins(omap, points_base, poses):
    """Per-point window origins (row0, col0), z-slabs and the fits flag of
    the TPU kernel's windows (pc_kernel.py:107-144): the prepass, then
    `window_finish` on (B,) vectors."""
    return window_finish(omap, pc_extents(omap, points_base, poses),
                         point_slabs(omap, points_base))


def pc_distances_plain(omap, points_base, poses) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, M) f32 distances in meters."""
    nz = omap.size[2]
    ci, cj = _cells(omap, points_base, poses)
    kz = point_slabs(omap, points_base)[:, None].expand_as(ci)
    ratio = omap.tex_zyx.reshape(-1)[omap.flat_index(ci, cj, kz)].to(torch.float32)
    d = torch.where(_on_map(omap, ci, cj), ratio, 255.0) \
        * float(np.float32(omap.max_distance_ratio))
    return torch.where((kz >= 0) & (kz < nz), d, omap.max_distance_to_object)


def pc_distances(omap, points_base, poses) -> torch.Tensor:
    """(B, M) f32 distances (meters) at every transformed cloud point."""
    _check_inputs(omap, points_base, poses)
    if poses.device.type != "cuda":
        return pc_distances_plain(omap, points_base, poses)
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


def pc_term_sums_plain(omap, points_base, poses, term) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (M,) f32 sums over the
    points of term(distance), the combine the windowed arm applied to the
    (B, M) distances."""
    return term(pc_distances_plain(omap, points_base, poses)).sum(dim=0)


def pc_term_sums(omap, points_base, poses, term) -> torch.Tensor:
    """Per-particle sums (M,) f32 over the cloud's points of `term` (a
    `PCTerm`) of the distance at `pc_distances`' own voxels: one launch on
    CUDA tensors, each term looked up in `term_table`, nothing (B, M) in
    memory."""
    _check_inputs(omap, points_base, poses)
    if poses.device.type != "cuda":
        return pc_term_sums_plain(omap, points_base, poses, term)
    if not isinstance(term, PCTerm):
        raise TypeError("the CUDA windowed point-cloud kernel computes a PCTerm only")
    m, b = poses.shape[0], points_base.shape[0]
    if m == 0 or b == 0:
        return torch.zeros((m,), dtype=torch.float32, device=poses.device)
    out = torch.empty((m,), dtype=torch.float32, device=poses.device)
    nx, ny, nz = omap.size
    poses, points_base = poses.contiguous(), points_base.contiguous()
    table = term_table(term, omap.max_distance_ratio, omap.max_distance_to_object,
                       poses.device)
    code = _build.lib().pc_term_sums_launch(
        omap.tex_zyx.contiguous().data_ptr(), nx, ny, nz, poses.data_ptr(), m,
        points_base.data_ptr(), b, _inv_res(omap), omap.min_cells[0], omap.min_cells[1],
        omap.min_cells[2], table.data_ptr(), out.data_ptr(), _build.stream_ptr(poses.device))
    _build.check(code, "pc_term_sums")
    pc_term_sums.launches += 1
    return out


pc_term_sums.launches = 0
