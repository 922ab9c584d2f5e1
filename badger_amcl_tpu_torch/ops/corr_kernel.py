"""Stencil-correlation likelihood on a pose lattice (counterpart of
badger_amcl_tpu.ops.corr_kernel, the single-robot f32 path).

On the lattice (map cells x quantized yaw) every particle sharing a cell
has the same score, a sparse correlation of the scan's endpoint stencil
with the per-cell beam-likelihood texture Psi:

    corr[t, dj, di] = sum_b  Psi[(j0 + dj) + oj(t, b), (i0 + di) + oi(t, b)]

with per-(yaw-bin, beam) offsets oj/oi = round(r_b u(theta_t + a_b) / res).
`corr_prepass` builds the packed offsets (compacted yaw bins and beams,
per-bin duplicates merged into weighted taps) and the dispatch flags;
`corr_table` builds the table (csrc/corr_table.cu on CUDA tensors,
`corr_table_plain` on CPU tensors); particles then read their value with
one take, fused with the model's combine and the recalcWeight factor when
folding (`_folded_take`).

Not ported (TPU-only): the eight row-preshifted texture copies
(`preshift_full`, `preshifted_slices`, `slice_origin*`) and the in-kernel
DMA variant — the CUDA kernel reads the padded texture directly — plus
the fleet and int8-quantized kernels (later work).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils.numerics import fdiv

PAD_R = 192  # row padding: >= max |row offset| + margin
PAD_C = 320  # col padding: >= max |col offset| + margin
PWIN_R = 64  # particle-cell window rows (j), standard variant
PWIN_R_NARROW = 32
PWIN_R_TIGHT = 24
PWIN_C = 128  # particle-cell window cols (i)
T_MAX = 64  # max active yaw bins per update
MIN_RANGE_CELLS = 16.0
MAX_RANGE_CELLS = 183.0  # = PAD_R - 9, the offset magnitude the padding allows
# the JAX kernel's active-region slice; kept for its static map gate
SLICE_R = 512
SLICE_C = 1024


def map_fits(omap) -> bool:
    """The JAX package's static gate: map large enough for its active-region
    slice (no upper size limit)."""
    return (omap.size_y + 2 * PAD_R >= SLICE_R + 8
            and omap.size_x + 2 * PAD_C >= SLICE_C
            and omap.size_y >= PWIN_R and omap.size_x >= PWIN_C)


def build_tex_pad(omap, tex_psi: torch.Tensor, offmap_psi: torch.Tensor) -> torch.Tensor:
    """Pad the per-cell psi texture with the off-map psi value
    (psi(max_distance), planar_scanner.cpp:295-300)."""
    pad = torch.zeros((omap.size_y + 2 * PAD_R, omap.size_x + 2 * PAD_C),
                      dtype=torch.float32, device=tex_psi.device)
    pad = pad + offmap_psi.to(torch.float32)
    pad[PAD_R:PAD_R + omap.size_y, PAD_C:PAD_C + omap.size_x] = tex_psi.to(torch.float32)
    return pad


def _compaction(flags: torch.Tensor, n_set: torch.Tensor):
    """Stable set-first permutation of a flag vector: (dest of each entry,
    order = inverse permutation), from cumulative sums."""
    fi = flags.to(torch.int32)
    dest = torch.where(flags, torch.cumsum(fi, 0, dtype=torch.int32) - 1,
                       n_set + torch.cumsum(1 - fi, 0, dtype=torch.int32) - 1)
    order = torch.empty_like(dest)
    order[dest.long()] = torch.arange(flags.shape[0], dtype=torch.int32,
                                      device=flags.device)
    return dest, order


def corr_prepass(omap, spose, ranges, angles, valid, dedup=False):
    """Lattice geometry: particle cells and windows, compacted yaw bins and
    beams, packed stencil offsets and the dynamic fits flags
    (corr_kernel.py:678-832). With dedup, per-bin duplicate offsets merge
    into one weighted tap (the psi sum is only reassociated)."""
    dev = spose.device
    res = omap.resolution
    ci, cj = omap.cells_of(spose[:, 0], spose[:, 1])
    ci = ci.clamp(0, omap.size_x - 1)
    cj = cj.clamp(0, omap.size_y - 1)
    i0 = ci.min()
    j0_raw = cj.min()
    row_span = cj.max() - j0_raw
    span_ok = (ci.max() - i0 < PWIN_C) & (row_span < PWIN_R)
    narrow_ok = span_ok & (row_span < PWIN_R_NARROW) & (omap.size_y >= PWIN_R_NARROW)
    tight_ok = span_ok & (row_span < PWIN_R_TIGHT) & (omap.size_y >= PWIN_R_TIGHT)
    # each variant clips from the RAW window origin
    i0 = i0.clamp(0, max(omap.size_x - PWIN_C, 0))
    j0 = j0_raw.clamp(0, max(omap.size_y - PWIN_R, 0))
    j0_n = j0_raw.clamp(0, max(omap.size_y - PWIN_R_NARROW, 0))
    j0_t = j0_raw.clamp(0, max(omap.size_y - PWIN_R_TIGHT, 0))

    # the longest valid range bounds the stencil offsets
    max_cells = fdiv(torch.where(valid, ranges, 0.0).max(), res)
    range_ok = (max_cells < (PAD_C - 129)) & (max_cells < (PAD_R - 9))
    # adaptive yaw-bin width: rounding error r*delta/2 <= half a cell
    dtheta = 1.0 / torch.clamp(max_cells, MIN_RANGE_CELLS, MAX_RANGE_CELLS)
    t_m = torch.round(spose[:, 2] / dtheta).to(torch.int32)
    t_min = t_m.min()
    yaw_ok = (t_m.max() - t_min + 1) <= T_MAX

    # occupied yaw bins compacted to the front, particles' compacted slots
    t_rel = (t_m - t_min).clamp(0, T_MAX - 1)
    t_occ = torch.zeros((T_MAX,), dtype=torch.bool, device=dev)
    t_occ[t_rel.long()] = True
    t_n = t_occ.sum().to(torch.int32)
    t_dest, t_order = _compaction(t_occ, t_n)
    t_slot = t_dest[t_rel.long()]

    # beam compaction: valid beams first (beam order is irrelevant to sums)
    nv = valid.sum().to(torch.int32)
    nb = valid.shape[0]
    _, b_order = _compaction(valid, nv)
    tail_ok = torch.arange(nb, dtype=torch.int32, device=dev) < nv
    ranges_c = torch.where(tail_ok, ranges.to(torch.float32)[b_order.long()], 0.0)
    angles_c = torch.where(tail_ok, angles.to(torch.float32)[b_order.long()], 0.0)

    # packed offsets (w << 20) | (oj & 0x3FF) << 10 | (oi & 0x3FF): 10-bit
    # signed offsets (|o| <= 183 by range_ok) and a 12-bit multiplicity
    theta = (t_min + t_order[:, None]).to(torch.float32) * dtheta + angles_c[None, :]
    inv_res = float(torch.tensor(1.0 / res, dtype=torch.float32))
    oi = torch.round(ranges_c[None, :] * torch.cos(theta) * inv_res).to(torch.int32)
    oj = torch.round(ranges_c[None, :] * torch.sin(theta) * inv_res).to(torch.int32)
    oo = ((oj & 0x3FF) << 10) | (oi & 0x3FF)

    if not dedup:
        off = (1 << 20) | oo
        nu = torch.full((T_MAX,), 0, dtype=torch.int32, device=dev) + nv
    else:
        # per-bin sort, run-length encode with cummax/cummin scans, then a
        # stable sort compacts the unique taps to the front
        sent = 0x1FFFFF  # > any 20-bit payload; sorts last
        x = torch.sort(torch.where(tail_ok[None, :], oo, sent), dim=1).values
        bsz = x.shape[1]
        idx = torch.arange(bsz, dtype=torch.int32, device=dev).expand_as(x)
        real = x != sent
        ones = torch.ones_like(real[:, :1])
        uniq = torch.cat([ones, x[:, 1:] != x[:, :-1]], dim=1) & real
        first = torch.cummax(torch.where(uniq, idx, -1), dim=1).values
        bnext = torch.cat([x[:, :-1] != x[:, 1:], ones], dim=1)
        last = torch.flip(torch.cummin(torch.flip(torch.where(bnext, idx, bsz), [1]),
                                       dim=1).values, [1])
        w = torch.where(uniq, last - first + 1, 0)
        # sentinel slots pack to 0 (a read tail slot contributes nothing)
        packed = torch.where(real, (w << 20) | x, 0)
        _, order = torch.sort(torch.where(uniq, 0, 1).to(torch.int32), dim=1,
                              stable=True)
        off = torch.gather(packed, 1, order)
        nu = uniq.sum(dim=1).to(torch.int32)
        nu = torch.where(torch.arange(T_MAX, device=dev) < t_n, nu, 0).to(torch.int32)

    return {
        "ci": ci, "cj": cj, "i0": i0, "j0": j0, "j0_narrow": j0_n,
        "j0_tight": j0_t, "t_slot": t_slot, "t_n": t_n, "nv": nv, "nu": nu,
        "off": off.reshape(-1).to(torch.int32).contiguous(),
        "fits": span_ok & yaw_ok & range_ok,
        "narrow": narrow_ok & yaw_ok & range_ok,
        "tight": tight_ok & yaw_ok & range_ok,
    }


def window_variant(pre, tight: bool, narrow: bool):
    """(rows, j0) of the smallest table the cloud's row span allows — the
    JAX package's `_window_cond_tree`, on host-read flags."""
    if tight:
        return PWIN_R_TIGHT, pre["j0_tight"]
    if narrow:
        return PWIN_R_NARROW, pre["j0_narrow"]
    return PWIN_R, pre["j0"]


def _unpack(off: torch.Tensor):
    """Packed taps -> (w, oj, oi) int64, decoded as the TPU kernel does."""
    o = off.to(torch.int64) & 0xFFFFFFFF
    w = o >> 20
    oj = (o >> 10) & 0x3FF
    oi = o & 0x3FF
    return w, torch.where(oj >= 512, oj - 1024, oj), torch.where(oi >= 512, oi - 1024, oi)


def corr_table_plain(tex_pad, off, nu, t_n, org, n_beams: int, rows: int):
    """Plain PyTorch version of the kernel: (T_MAX, rows, PWIN_C) f32, bins
    t >= t_n zero. org: (2,) int32 absolute window origin in tex_pad."""
    dev = tex_pad.device
    hp, wp = tex_pad.shape
    t_max = nu.shape[0]
    w, oj, oi = _unpack(off.reshape(t_max, n_beams))
    live = torch.arange(n_beams, device=dev)[None, :] < nu[:, None]
    wf = torch.where(live, w, 0).to(torch.float32)
    org = org.to(torch.int64)
    dj = torch.arange(rows, device=dev)
    di = torch.arange(PWIN_C, device=dev)
    out = torch.zeros((t_max, rows, PWIN_C), dtype=torch.float32, device=dev)
    for t in range(int(t_n)):
        r = (org[0] + oj[t][:, None] + dj[None, :]).clamp(0, hp - 1)  # (B, rows)
        c = (org[1] + oi[t][:, None] + di[None, :]).clamp(0, wp - 1)  # (B, PWIN_C)
        g = tex_pad[r[:, :, None], c[:, None, :]]  # (B, rows, PWIN_C)
        out[t] = (wf[t][:, None, None] * g).sum(dim=0)
    return out


def corr_table(tex_pad, off, nu, t_n, org, n_beams: int, rows: int):
    """The correlation table (T_MAX, rows, PWIN_C) f32 for packed taps `off`
    (T_MAX * n_beams,) int32, per-bin tap counts `nu` (T_MAX,) int32, the
    occupied-bin count `t_n` (0-dim int32) and window origin `org` (2,)
    int32 = (j0 + PAD_R, i0 + PAD_C) in the padded texture."""
    t_max = nu.shape[0]
    if tex_pad.dim() != 2 or tex_pad.dtype != torch.float32:
        raise ValueError("tex_pad must be a 2-D float32 texture")
    if off.shape != (t_max * n_beams,) or off.dtype != torch.int32:
        raise ValueError("off must be (T_MAX * n_beams,) int32")
    if nu.dtype != torch.int32 or org.shape != (2,) or org.dtype != torch.int32:
        raise ValueError("nu must be int32 and org a (2,) int32 origin")
    if rows not in (PWIN_R_TIGHT, PWIN_R_NARROW, PWIN_R):
        raise ValueError(f"rows must be one of 24, 32, 64, got {rows}")
    if tex_pad.device.type != "cuda":
        return corr_table_plain(tex_pad, off, nu, t_n, org, n_beams, rows)
    for t in (off, nu, t_n, org):
        if t.device != tex_pad.device:
            raise ValueError("all inputs must be on one device")
    tex_pad = tex_pad.contiguous()
    off, nu, org = off.contiguous(), nu.contiguous(), org.contiguous()
    t_n = t_n.to(torch.int32).reshape(1).contiguous()
    out = torch.empty((t_max, rows, PWIN_C), dtype=torch.float32, device=tex_pad.device)
    hp, wp = tex_pad.shape
    code = _build.lib().corr_table_launch(
        tex_pad.data_ptr(), hp, wp, off.data_ptr(), nu.data_ptr(), t_n.data_ptr(),
        org.data_ptr(), out.data_ptr(), t_max, n_beams, rows,
        _build.stream_ptr(tex_pad.device))
    _build.check(code, "corr_table")
    corr_table.launches += 1
    return out


corr_table.launches = 0


def table_origin(pre, j0) -> torch.Tensor:
    """(2,) int32 absolute origin of a table window in the padded texture."""
    return torch.stack([j0 + PAD_R, pre["i0"] + PAD_C]).to(torch.int32)


def particle_flat(pre, rows: int, j0) -> torch.Tensor:
    """Flat int64 index of each particle's lattice cell in a (T_MAX, rows,
    PWIN_C) table."""
    dj = (pre["cj"] - j0).clamp(0, rows - 1)
    di = (pre["ci"] - pre["i0"]).clamp(0, PWIN_C - 1)
    return ((pre["t_slot"] * rows + dj) * PWIN_C + di).long()


@dataclasses.dataclass
class Fold:
    """Factor folding into the table read: `combine` maps psi sums to p,
    `factor_tex` is the recalcWeight factor texture, `all_valid` whether
    every particle is on the map (host value), `fallback_mf` the
    per-particle factors for the generic arm."""

    combine: Callable
    factor_tex: torch.Tensor
    all_valid: bool
    fallback_mf: Callable


def _folded_take(corr_s, pre, rows, j0, fold: Fold):
    """Apply combine and the per-cell factor TABLE-side, then one
    per-particle take returns p * factor (exact: the take picks single
    elements). Off-map particles need the off-map factor, so the fused arm
    runs only when every particle is on the map (recalcWeight,
    planar_scanner.cpp:646-650)."""
    flat_idx = particle_flat(pre, rows, j0)
    if fold.all_valid:
        jj = (j0 + torch.arange(rows, device=corr_s.device)).long()
        ii = (pre["i0"] + torch.arange(PWIN_C, device=corr_s.device)).long()
        fwin = fold.factor_tex[jj[:, None], ii[None, :]]
        c2 = fold.combine(corr_s) * fwin[None]
        return c2.reshape(-1)[flat_idx]
    p = fold.combine(corr_s.reshape(-1)[flat_idx])
    return p * fold.fallback_mf()


def corr_values(tex_pad, pre, n_beams: int, rows: int, j0, fold: Fold = None):
    """Build the table for one window variant and read each particle's value:
    (M,) psi sums, or with `fold` the final p * factor per particle."""
    corr = corr_table(tex_pad, pre["off"], pre["nu"], pre["t_n"],
                      table_origin(pre, j0), n_beams, rows)
    if fold is not None:
        return _folded_take(corr, pre, rows, j0, fold)
    return corr.reshape(-1)[particle_flat(pre, rows, j0)]
