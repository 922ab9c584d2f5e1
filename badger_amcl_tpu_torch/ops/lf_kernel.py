"""Distance-field lookup at every scan endpoint, (B, M) orientation
(counterpart of badger_amcl_tpu.ops.lf_kernel).

`lf_distances` is the kernel wrapper: CUDA tensors launch
csrc/lf_distances.cu, CPU tensors run `lf_distances_plain`. `lf_distances_t`
keeps the JAX package's contract: where its windowed TPU kernel would run
(every beam's endpoints fit a WIN_ROWS x WIN_COLS window, `window_origins`)
the texture is read in bf16, which is what that kernel returns; elsewhere
it is read in f32, which is the JAX package's exact gather. Both arms run
on the same kernel. The per-beam windows themselves are not ported: a GPU
gathers directly.
"""

from __future__ import annotations

import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils.numerics import host_bool

WIN_ROWS = 64
WIN_COLS = 256


def window_origins(omap, spose, ranges, angles):
    """Per-beam window origins (row0, col0) and the global fits flag of the
    TPU kernel's windows, with its (8, 128) alignment (lf_kernel.py:108-133)."""
    th = spose[:, 2:3] + angles[None, :]
    hx = spose[:, 0:1] + ranges[None, :] * torch.cos(th)
    hy = spose[:, 1:2] + ranges[None, :] * torch.sin(th)
    ci, cj = omap.cells_of(hx, hy)
    inmap = omap.in_bounds(ci, cj)
    big = 1 << 30
    ci_min = torch.where(inmap, ci, big).min(dim=0).values
    ci_max = torch.where(inmap, ci, -big).max(dim=0).values
    cj_min = torch.where(inmap, cj, big).min(dim=0).values
    cj_max = torch.where(inmap, cj, -big).max(dim=0).values
    row0 = torch.where(cj_min == big, 0, cj_min) & ~7
    col0 = torch.where(ci_min == big, 0, ci_min) & ~127
    fits = torch.all(((ci_max - col0) < WIN_COLS) & ((cj_max - row0) < WIN_ROWS))
    row0 = row0.clamp(0, omap.size_y - WIN_ROWS) & ~7
    col0 = col0.clamp(0, omap.size_x - WIN_COLS) & ~127
    return row0.to(torch.int32), col0.to(torch.int32), fits


def lf_distances_plain(omap, tex, spose, ranges, angles):
    """Plain PyTorch version of the kernel: (B, M) f32 texture values at the
    endpoints, off-map -> max distance."""
    th = spose[None, :, 2] + angles[:, None]
    hx = spose[None, :, 0] + ranges[:, None] * torch.cos(th)
    hy = spose[None, :, 1] + ranges[:, None] * torch.sin(th)
    ci, cj = omap.cells_of(hx, hy)
    d = tex.reshape(-1)[omap.flat_index(ci, cj)].to(torch.float32)
    return torch.where(omap.in_bounds(ci, cj), d,
                       torch.full_like(d, omap.max_distance_to_object))


def lf_distances(omap, tex, spose, ranges, angles):
    """(B, M) f32 values of `tex` ((H, W) f32 or bf16) at every endpoint."""
    if tex.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"texture must be float32 or bfloat16, got {tex.dtype}")
    if tuple(tex.shape) != (omap.size_y, omap.size_x):
        raise ValueError(f"texture shape {tuple(tex.shape)} != map "
                         f"{(omap.size_y, omap.size_x)}")
    if spose.dim() != 2 or spose.shape[1] != 3 or spose.dtype != torch.float32:
        raise ValueError("spose must be (M, 3) float32")
    if ranges.shape != angles.shape or ranges.dim() != 1:
        raise ValueError("ranges and angles must be matching (B,) vectors")
    if spose.device.type != "cuda":
        return lf_distances_plain(omap, tex, spose, ranges, angles)
    for t in (tex, ranges, angles):
        if t.device != spose.device:
            raise ValueError("all inputs must be on one device")
    m, b = spose.shape[0], ranges.shape[0]
    out = torch.empty((b, m), dtype=torch.float32, device=spose.device)
    if m == 0 or b == 0:
        return out
    tex = tex.contiguous()
    px, py, pth = (spose[:, k].contiguous() for k in range(3))
    r = ranges.to(torch.float32).contiguous()
    a = angles.to(torch.float32).contiguous()
    lib = _build.lib()
    fn = lib.lf_distances_bf16_launch if tex.dtype == torch.bfloat16 \
        else lib.lf_distances_f32_launch
    code = fn(tex.data_ptr(), px.data_ptr(), py.data_ptr(), pth.data_ptr(), m,
              r.data_ptr(), a.data_ptr(), b, omap.resolution, omap.origin_x,
              omap.origin_y, omap.size_x // 2, omap.size_y // 2, omap.size_x,
              omap.size_y, omap.max_distance_to_object, out.data_ptr(),
              _build.stream_ptr(spose.device))
    _build.check(code, "lf_distances")
    lf_distances.launches += 1
    return out


lf_distances.launches = 0


def lf_distances_t(omap, spose, ranges, angles):
    """Full LF distance lookup in (B, M) orientation: bf16 texture where the
    TPU kernel's windows fit (its contract), f32 texture where the JAX
    package takes the exact gather (maps under the window size, or a
    spread cloud)."""
    tex = omap.distances
    if omap.size_x >= WIN_COLS and omap.size_y >= WIN_ROWS:
        _, _, fits = window_origins(omap, spose, ranges, angles)
        if host_bool(fits):
            tex = tex.to(torch.bfloat16)
    return lf_distances(omap, tex, spose, ranges, angles)
