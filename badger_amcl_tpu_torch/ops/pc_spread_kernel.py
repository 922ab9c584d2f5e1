"""Per-particle point-cloud term sums for SPREAD particle clouds
(counterpart of badger_amcl_tpu.ops.pc_spread_kernel, the 3D lift of
ops/spread_kernel.py).

A transformed cloud point is the 2D spread kernel's bilinear form: its
texture cell is floor(pxc + A cos(theta) - B sin(theta)) with per-point
(A, B) = (qx, qy) / res and pxc = px / res + (0.5 - min_i), the TPU
kernel's own formula (pc_spread_kernel.py:197-199, :445-446), and its
z-slab is the same for every particle. The uint8 ratio at the cell times
max_distance_ratio is the distance, 255 off the map; a point outside the
z band contributes term(max_distance_to_object) to every particle
(:595-597).

`pc_spread_term_sums` is the kernel wrapper: CUDA tensors launch
csrc/pc_spread_term_sums.cu (a prep launch that sorts the cloud's points
by slab and position, then the sums, which look each pair's `PCTerm` up
in `pc_kernel.term_table`: the term at the 256 ratios and outside the z
band, which the windowed arm's fused sums share); CPU
tensors run `pc_spread_term_sums_plain`, which takes any elementwise term.
Sums come out in particle order.

Not ported (TPU-only machinery): `pc_spread_prepass` (the (class, yaw
bin, block) particle sort and the tier flags) and `point_prep`'s padding
of slab runs (the CUDA prep sorts the points in a key of its own), the
window tiers, `_escape_term_sums3` and `unsort`.
A direct gather covers every (particle, point) pair, so the JAX dispatch's
fallback when `pre["fits"]` is false (escape capacity, point-slot budget)
has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.ops.pc_kernel import (
    PCTerm, _check_inputs, _inv_res, point_slabs, term_table,
)

ROWS1 = 224
LOAD_C1 = 256 + 128
MAX_TEX_BYTES = 10 * 1024 * 1024


def tex_fits(omap) -> bool:
    """The JAX package's static gate for its spread kernel (texture within
    its VMEM budget, map at least one window, pc_spread_kernel.py:80-86) —
    kept as the dispatch predicate so the port takes the same arm."""
    nx, ny, nz = omap.size
    return nx * ny * nz <= MAX_TEX_BYTES and ny >= ROWS1 and nx >= LOAD_C1


def endpoint_inputs(omap, poses, points_base):
    """Per-particle cell-space position and cos/sin yaw, per-point A, B and
    z-slab (pc_spread_kernel.py:98-145, :445-448)."""
    inv_res = _inv_res(omap)
    pxc = poses[:, 0] * inv_res + (0.5 - omap.min_cells[0])
    pyc = poses[:, 1] * inv_res + (0.5 - omap.min_cells[1])
    ct, st = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    a = points_base[:, 0] * inv_res
    b = points_base[:, 1] * inv_res
    return pxc, pyc, ct, st, a, b, point_slabs(omap, points_base)


def pc_spread_term_sums_plain(omap, pxc, pyc, ct, st, a, b, slab, term):
    """Plain PyTorch version: (M,) sums over all points of term(z)."""
    nx, ny, nz = omap.size
    ci = torch.floor(pxc[None, :] + a[:, None] * ct[None, :]
                     - b[:, None] * st[None, :]).to(torch.int32)
    cj = torch.floor(pyc[None, :] + b[:, None] * ct[None, :]
                     + a[:, None] * st[None, :]).to(torch.int32)
    kz = slab[:, None].expand_as(ci)
    ratio = omap.tex_zyx.reshape(-1)[omap.flat_index(ci, cj, kz)].to(torch.float32)
    inmap = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny)
    z = torch.where(inmap, ratio, 255.0) * float(np.float32(omap.max_distance_ratio))
    z = torch.where((kz >= 0) & (kz < nz), z, omap.max_distance_to_object)
    return term(z).sum(dim=0)


def pc_spread_term_sums(omap, poses, points_base, term) -> torch.Tensor:
    """Per-particle sums of term(distance) over every cloud point (every
    point counts, point_cloud_scanner.cpp:132-167), (M,) f32 in particle
    order."""
    _check_inputs(omap, points_base, poses)
    if poses.device.type != "cuda":
        return pc_spread_term_sums_plain(omap, *endpoint_inputs(omap, poses, points_base),
                                         term)
    if not isinstance(term, PCTerm):
        raise TypeError("the CUDA point-cloud spread kernel computes a PCTerm only")
    m, b = poses.shape[0], points_base.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=poses.device)
    if m == 0:
        return out
    nx, ny, nz = omap.size
    poses, points_base = poses.contiguous(), points_base.contiguous()
    table = term_table(term, omap.max_distance_ratio, omap.max_distance_to_object,
                       poses.device)
    # the int64 slab offsets, then the sort keys and the sorted (A, B)
    scratch = torch.empty((5 * b,), dtype=torch.int32, device=poses.device)
    code = _build.lib().pc_spread_term_sums_launch(
        omap.tex_zyx.contiguous().data_ptr(), nx, ny, nz, poses.data_ptr(), m,
        points_base.data_ptr(), b, _inv_res(omap), omap.min_cells[0],
        omap.min_cells[1], omap.min_cells[2], table.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), _build.stream_ptr(poses.device))
    _build.check(code, "pc_spread_term_sums")
    pc_spread_term_sums.launches += 1
    return out


pc_spread_term_sums.launches = 0
