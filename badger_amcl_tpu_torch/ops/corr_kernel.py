"""Stencil-correlation likelihood on a pose lattice (counterpart of
badger_amcl_tpu.ops.corr_kernel, the single-robot f32 path).

On the lattice (map cells x quantized yaw) every particle sharing a cell
has the same score, a sparse correlation of the scan's endpoint stencil
with the per-cell beam-likelihood texture Psi:

    corr[t, dj, di] = sum_b  Psi[(j0 + dj) + oj(t, b), (i0 + di) + oi(t, b)]

with per-(yaw-bin, beam) offsets oj/oi = round(r_b u(theta_t + a_b) / res).
`corr_prepass` builds the packed offsets (compacted yaw bins and beams,
per-bin duplicates merged into weighted taps) and the dispatch flags, for
one robot or, with a leading robot axis, a fleet; particles then read
their value with one take, fused with the model's combine and the
recalcWeight factor when folding (`_folded_take`), or, under the
cell-space resampling contract, keep the folded table and each
particle's cell key (`corr_cells`, no take). Three tables, each a
wrapper that launches its kernel on CUDA tensors (csrc/corr_table.cu: one
templated tap loop for the single-robot tables, a kernel of its own for the
fleet) and runs its plain version on CPU tensors:

- `corr_table`: one robot, f32 psi texture (TPU kernels `_kernel_pre`
  and `_kernel`);
- `fleet_corr_table`: R robots in one launch, each at its own window
  origin, undeduplicated unit taps (TPU kernel `_kernel_fleet`); a robot
  without valid beams gets zero taps (the JAX fleet kernel runs one);
- `corr_table_q`: one robot over the int8 ratio-quantized texture
  (`build_tex_pad_q`), int32 sums dequantized per particle as
  acc * qstep + nv * qoff (TPU kernel `_kernel_q`).

Not ported (TPU-only): the eight row-preshifted texture copies
(`preshift_full`, `preshifted_slices`, `slice_origin*`) and the in-kernel
DMA variant, the fleet kernel's per-robot (512, 1024) slices, 8-row
robot blocking and row rolls, and the q kernel's four preshifted int8
copies, 32-row aligned loads and bitcast rolls: every kernel reads its
padded texture directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils import control
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
# the int8 texture's row padding (PAD_R + 32 for the TPU's aligned loads;
# kept so the q texture and its gate match the JAX package's)
PAD_RQ = 224
BASE_RQ = 512 + 3  # the JAX q kernel's base slice rows (its map gate)


def map_fits(omap) -> bool:
    """The JAX package's static gate: map large enough for its active-region
    slice (no upper size limit)."""
    return (omap.size_y + 2 * PAD_R >= SLICE_R + 8
            and omap.size_x + 2 * PAD_C >= SLICE_C
            and omap.size_y >= PWIN_R and omap.size_x >= PWIN_C)


def map_fits_q(omap) -> bool:
    """The JAX package's static gate of the int8 variant (laxer rows than
    map_fits: its 224-row padding nearly covers the base slice)."""
    return (omap.size_y + 2 * PAD_RQ >= BASE_RQ
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


def build_tex_pad_q(omap, tex_psi: torch.Tensor, offmap_psi: torch.Tensor):
    """The psi texture ratio-quantized to int8 between its [lo, hi]
    (corr_kernel.py:532-555) and padded by PAD_RQ rows / PAD_C columns with
    the quantized off-map value. Returns (pad_q int8, qscale (2,) f32 =
    [qstep, lo + 127 qstep]): sum_b psi ~ qstep * sum_b q + nv * qoff.
    Both divisions are IEEE (`fdiv`, a tensor divisor), so a bake on the
    card equals one on the CPU; a uniform texture takes qstep 1."""
    tex = tex_psi.to(torch.float32)
    off = offmap_psi.to(torch.float32)
    lo = torch.minimum(tex.min(), off)
    hi = torch.maximum(tex.max(), off)
    step = torch.where(hi > lo, fdiv(hi - lo, 254.0), 1.0)

    def quantize(x):
        return (torch.round((x - lo) / step).clamp(0, 254).to(torch.int16) - 127).to(torch.int8)

    pad = torch.empty((omap.size_y + 2 * PAD_RQ, omap.size_x + 2 * PAD_C), dtype=torch.int8,
                      device=tex.device).fill_(quantize(off))
    pad[PAD_RQ:PAD_RQ + omap.size_y, PAD_C:PAD_C + omap.size_x] = quantize(tex)
    return pad, torch.stack([step, lo + 127.0 * step])


def _compaction(flags: torch.Tensor, n_set: torch.Tensor):
    """Stable set-first permutation along the last axis of a flag tensor
    (..., n): (dest of each entry, order = inverse permutation), from
    cumulative sums; n_set (...) the set counts."""
    fi = flags.to(torch.int32)
    dest = torch.where(flags, torch.cumsum(fi, -1, dtype=torch.int32) - 1,
                       n_set[..., None] + torch.cumsum(1 - fi, -1, dtype=torch.int32) - 1)
    order = torch.empty_like(dest)
    iota = torch.arange(flags.shape[-1], dtype=torch.int32, device=flags.device)
    order.scatter_(-1, dest.long(), iota.expand_as(dest).contiguous())
    return dest, order


def corr_prepass(omap, spose, ranges, angles, valid, dedup=False):
    """Lattice geometry: particle cells and windows, compacted yaw bins and
    beams, packed stencil offsets and the dynamic fits flags
    (corr_kernel.py:678-832). With dedup, per-bin duplicate offsets merge
    into one weighted tap (the psi sum is only reassociated).

    One robot: spose (N, 3), ranges/angles/valid (B,). A fleet (the JAX
    fleet's vmapped prepass, fleet.py:160-162): spose (R, N, 3) and
    (R, B) scans; every output then carries the leading robot axis
    ("off" is (R, T_MAX * B))."""
    if spose.dim() == 2:
        pre = corr_prepass(omap, spose[None], ranges[None], angles[None], valid[None],
                           dedup)
        return {k: v[0] for k, v in pre.items()}
    dev = spose.device
    res = omap.resolution
    r = spose.shape[0]
    ci, cj = omap.cells_of(spose[..., 0], spose[..., 1])
    ci = ci.clamp(0, omap.size_x - 1)
    cj = cj.clamp(0, omap.size_y - 1)
    i0 = ci.min(-1).values
    j0_raw = cj.min(-1).values
    row_span = cj.max(-1).values - j0_raw
    span_ok = (ci.max(-1).values - i0 < PWIN_C) & (row_span < PWIN_R)
    narrow_ok = span_ok & (row_span < PWIN_R_NARROW) & (omap.size_y >= PWIN_R_NARROW)
    tight_ok = span_ok & (row_span < PWIN_R_TIGHT) & (omap.size_y >= PWIN_R_TIGHT)
    # each variant clips from the RAW window origin
    i0 = i0.clamp(0, max(omap.size_x - PWIN_C, 0))
    j0 = j0_raw.clamp(0, max(omap.size_y - PWIN_R, 0))
    j0_n = j0_raw.clamp(0, max(omap.size_y - PWIN_R_NARROW, 0))
    j0_t = j0_raw.clamp(0, max(omap.size_y - PWIN_R_TIGHT, 0))

    # the longest valid range bounds the stencil offsets
    max_cells = fdiv(torch.where(valid, ranges, 0.0).max(-1).values, res)
    range_ok = (max_cells < (PAD_C - 129)) & (max_cells < (PAD_R - 9))
    # adaptive yaw-bin width: rounding error r*delta/2 <= half a cell
    dtheta = 1.0 / torch.clamp(max_cells, MIN_RANGE_CELLS, MAX_RANGE_CELLS)
    t_m = torch.round(spose[..., 2] / dtheta[:, None]).to(torch.int32)
    t_min = t_m.min(-1).values
    yaw_ok = (t_m.max(-1).values - t_min + 1) <= T_MAX

    # occupied yaw bins compacted to the front, particles' compacted slots
    t_rel = (t_m - t_min[:, None]).clamp(0, T_MAX - 1).long()
    t_occ = torch.zeros((r, T_MAX), dtype=torch.bool, device=dev)
    t_occ.scatter_(1, t_rel, True)
    t_n = t_occ.sum(-1).to(torch.int32)
    t_dest, t_order = _compaction(t_occ, t_n)
    t_slot = torch.gather(t_dest, 1, t_rel)

    # beam compaction: valid beams first (beam order is irrelevant to sums)
    nv = valid.sum(-1).to(torch.int32)
    nb = valid.shape[-1]
    _, b_order = _compaction(valid, nv)
    tail_ok = torch.arange(nb, dtype=torch.int32, device=dev) < nv[:, None]
    b_order = b_order.long()
    ranges_c = torch.where(tail_ok, torch.gather(ranges.to(torch.float32), 1, b_order), 0.0)
    angles_c = torch.where(tail_ok, torch.gather(angles.to(torch.float32), 1, b_order), 0.0)

    # packed offsets (w << 20) | (oj & 0x3FF) << 10 | (oi & 0x3FF): 10-bit
    # signed offsets (|o| <= 183 by range_ok) and a 12-bit multiplicity
    theta = ((t_min[:, None, None] + t_order[:, :, None]).to(torch.float32)
             * dtheta[:, None, None] + angles_c[:, None, :])
    inv_res = float(np.float32(1.0 / res))
    oi = torch.round(ranges_c[:, None, :] * torch.cos(theta) * inv_res).to(torch.int32)
    oj = torch.round(ranges_c[:, None, :] * torch.sin(theta) * inv_res).to(torch.int32)
    oo = ((oj & 0x3FF) << 10) | (oi & 0x3FF)

    if not dedup:
        off = (1 << 20) | oo
        nu = torch.zeros((r, T_MAX), dtype=torch.int32, device=dev) + nv[:, None]
    else:
        # per-bin sort, run-length encode with cummax/cummin scans, then a
        # stable sort compacts the unique taps to the front
        sent = 0x1FFFFF  # > any 20-bit payload; sorts last
        x = torch.sort(torch.where(tail_ok[:, None, :], oo, sent), dim=-1).values
        bsz = x.shape[-1]
        idx = torch.arange(bsz, dtype=torch.int32, device=dev).expand_as(x)
        real = x != sent
        ones = torch.ones_like(real[..., :1])
        uniq = torch.cat([ones, x[..., 1:] != x[..., :-1]], dim=-1) & real
        first = torch.cummax(torch.where(uniq, idx, -1), dim=-1).values
        bnext = torch.cat([x[..., :-1] != x[..., 1:], ones], dim=-1)
        last = torch.flip(torch.cummin(torch.flip(torch.where(bnext, idx, bsz), [-1]),
                                       dim=-1).values, [-1])
        w = torch.where(uniq, last - first + 1, 0)
        # sentinel slots pack to 0 (a read tail slot contributes nothing)
        packed = torch.where(real, (w << 20) | x, 0)
        _, order = torch.sort(torch.where(uniq, 0, 1).to(torch.int32), dim=-1,
                              stable=True)
        off = torch.gather(packed, -1, order)
        nu = uniq.sum(dim=-1).to(torch.int32)
        nu = torch.where(torch.arange(T_MAX, device=dev) < t_n[:, None], nu,
                         0).to(torch.int32)

    return {
        "ci": ci, "cj": cj, "i0": i0, "j0": j0, "j0_narrow": j0_n,
        "j0_tight": j0_t, "t_slot": t_slot, "t_n": t_n, "nv": nv, "nu": nu,
        "off": off.reshape(r, -1).to(torch.int32).contiguous(),
        "fits": span_ok & yaw_ok & range_ok,
        "narrow": narrow_ok & yaw_ok & range_ok,
        "tight": tight_ok & yaw_ok & range_ok,
    }


def window_cond(pre, tight, narrow, run, name: str = "corr.window"):
    """run(rows, j0) on the smallest table the cloud's row span allows: the
    JAX package's `_window_cond_tree` (corr_kernel.py:910-922), nested
    `control.cond`s on tight, then narrow (read bools, or device flags in a
    capture). Each variant keeps its own static rows; run must return the
    same shapes for all three."""
    return control.cond(
        tight, lambda: run(PWIN_R_TIGHT, pre["j0_tight"]),
        lambda: control.cond(narrow, lambda: run(PWIN_R_NARROW, pre["j0_narrow"]),
                             lambda: run(PWIN_R, pre["j0"]), name=f"{name}.narrow"),
        name=f"{name}.tight")


def window_variant(pre, tight: bool, narrow: bool):
    """(rows, j0) of `window_cond`'s choice, on read flags."""
    return window_cond(pre, tight, narrow, lambda rows, j0: (rows, j0))


def _unpack(off: torch.Tensor):
    """Packed taps -> (w, oj, oi) int64, decoded as the TPU kernel does."""
    o = off.to(torch.int64) & 0xFFFFFFFF
    w = o >> 20
    oj = (o >> 10) & 0x3FF
    oi = o & 0x3FF
    return w, torch.where(oj >= 512, oj - 1024, oj), torch.where(oi >= 512, oi - 1024, oi)


@control.plain_version
def _table_plain(tex, off, nu, t_n, org, n_beams: int, rows: int):
    """The plain tap sum of every table kernel, R windows at once: off
    (R, T_MAX * n_beams) packed taps, nu (R, T_MAX) taps per bin, t_n
    (R,), org (R, 2) absolute window origins in `tex`. Returns (R, T_MAX,
    rows, PWIN_C), bins t >= t_n zero: f32 for an f32 texture, int32
    (exact) for the int8 one."""
    dev = tex.device
    hp, wp = tex.shape
    n_r, t_max = nu.shape
    w, oj, oi = _unpack(off.reshape(n_r, t_max, n_beams))
    live = torch.arange(n_beams, device=dev) < nu[..., None]
    integer = tex.dtype == torch.int8
    w = torch.where(live, w, 0)
    w = w if integer else w.to(torch.float32)
    org = org.to(torch.int64)
    dj = torch.arange(rows, device=dev)
    di = torch.arange(PWIN_C, device=dev)
    flat_tex = tex.reshape(-1)
    out = torch.zeros((n_r, t_max, rows, PWIN_C), dtype=torch.int32 if integer else torch.float32,
                      device=dev)
    n_bins = int(t_n.max()) if n_r else 0
    for t in range(n_bins):
        r = (org[:, 0, None, None] + oj[:, t, :, None] + dj).clamp(0, hp - 1)  # (R, B, rows)
        c = (org[:, 1, None, None] + oi[:, t, :, None] + di).clamp(0, wp - 1)  # (R, B, PWIN_C)
        g = flat_tex[r[..., None] * wp + c[:, :, None, :]]  # (R, B, rows, PWIN_C)
        if integer:
            g = g.to(torch.int64)
        s = (w[:, t, :, None, None] * g).sum(dim=1)
        out[:, t] = torch.where((t < t_n)[:, None, None], s, 0).to(out.dtype)
    return out


def _table_in_order(tex, off, nu, t_n, org, n_beams: int, rows: int):
    """`_table_plain` for an f32 texture with every cell's taps added one at
    a time in tap order, `acc + w * g` with the product and the sum each
    rounded: the order of the TPU kernels' sequential tap loop
    (corr_kernel.py:140-153, :310-323) and of the CUDA kernels, which
    agree with it bit for bit. So does the JAX fleet kernel in interpret
    mode (unit taps leave no product to round); XLA's CPU compile of the
    single-robot loop fuses a weighted tap's `acc + w * block` into one
    multiply-add instead."""
    dev = tex.device
    hp, wp = tex.shape
    n_r, t_max = nu.shape
    w, oj, oi = _unpack(off.reshape(n_r, t_max, n_beams))
    out = torch.zeros((n_r, t_max, rows, PWIN_C), dtype=torch.float32, device=dev)
    n_bins = int(t_n.max()) if n_r else 0
    if n_bins == 0:
        return out
    org = org.to(torch.int64)
    dj = torch.arange(rows, device=dev)
    di = torch.arange(PWIN_C, device=dev)
    flat_tex = tex.reshape(-1)
    live_bin = (torch.arange(n_bins, device=dev) < t_n[:, None])[..., None, None]
    acc = out[:, :n_bins]
    for b in range(int(nu[:, :n_bins].max())):
        r = (org[:, 0, None, None] + oj[:, :n_bins, b, None] + dj).clamp(0, hp - 1)
        c = (org[:, 1, None, None] + oi[:, :n_bins, b, None] + di).clamp(0, wp - 1)
        g = flat_tex[r[..., None] * wp + c[:, :, None, :]]  # (R, n_bins, rows, PWIN_C)
        live = live_bin & (b < nu[:, :n_bins])[..., None, None]
        acc = torch.where(live, acc + w[:, :n_bins, b, None, None].to(torch.float32) * g, acc)
    out[:, :n_bins] = acc
    return out


def _check_taps(tex, tex_dtype, off, tap_counts, t_n, org, n_beams, rows, row_choices):
    """Argument checks shared by the table wrappers, on the tensors as given
    (no views: the single-robot wrappers run on every step, and each view
    costs the host microseconds). One window: off (T_MAX * n_beams,),
    per-bin tap counts (T_MAX,), one t_n, org (2,). R windows, robot axis
    first: off (R, T_MAX * n_beams), one tap count per window (R,), t_n
    (R,), org (R, 2)."""
    lead = org.shape[:-1]
    if tex.dim() != 2 or tex.dtype != tex_dtype:
        raise ValueError(f"the texture must be a 2-D {tex_dtype} tensor")
    if off.shape != (*lead, T_MAX * n_beams) or off.dtype != torch.int32:
        raise ValueError("off must be (T_MAX * n_beams,) int32 per window")
    if (tap_counts.shape != (lead or (T_MAX,)) or tap_counts.dtype != torch.int32
            or org.shape[-1:] != (2,) or org.dtype != torch.int32
            or t_n.shape not in (lead, lead or (1,))):
        raise ValueError("tap counts and t_n must be int32 and org (2,) int32 per window")
    if rows not in row_choices:
        raise ValueError(f"rows must be one of {row_choices}, got {rows}")
    if lead and not 0 < lead[0] <= 65535:
        raise ValueError(f"1 to 65535 windows per launch, got {lead[0]}")
    if tex.device.type == "cuda":
        for t in (off, tap_counts, t_n, org):
            if t.device != tex.device:
                raise ValueError("all inputs must be on one device")


def _launch(fn_name, tex, out, *ints_and_ptrs):
    """Call a table kernel's C entry point on tex's stream."""
    code = getattr(_build.lib(), fn_name)(*ints_and_ptrs, _build.stream_ptr(tex.device))
    _build.check(code, fn_name)
    return out


def _single_table(fn_name, tex, off, nu, t_n, org, n_beams, rows, out_dtype):
    """Launch a single-robot table kernel into a new (T_MAX, rows, PWIN_C)
    table."""
    tex, off, nu, org = (t.contiguous() for t in (tex, off, nu, org))
    out = torch.empty((T_MAX, rows, PWIN_C), dtype=out_dtype, device=tex.device)
    return _launch(fn_name, tex, out, tex.data_ptr(), *tex.shape, off.data_ptr(),
                   nu.data_ptr(), t_n.data_ptr(), org.data_ptr(), out.data_ptr(), T_MAX,
                   n_beams, rows)


def corr_table_plain(tex_pad, off, nu, t_n, org, n_beams: int, rows: int):
    """Plain PyTorch version of `corr_table`."""
    return _table_plain(tex_pad, off[None], nu[None], t_n.reshape(1), org[None],
                        n_beams, rows)[0]


def corr_table(tex_pad, off, nu, t_n, org, n_beams: int, rows: int):
    """The correlation table (T_MAX, rows, PWIN_C) f32 for packed taps `off`
    (T_MAX * n_beams,) int32, per-bin tap counts `nu` (T_MAX,) int32, the
    occupied-bin count `t_n` (0-dim int32) and window origin `org` (2,)
    int32 = (j0 + PAD_R, i0 + PAD_C) in the padded texture."""
    t_n = t_n.to(torch.int32)
    _check_taps(tex_pad, torch.float32, off, nu, t_n, org, n_beams, rows,
                (PWIN_R_TIGHT, PWIN_R_NARROW, PWIN_R))
    if tex_pad.device.type != "cuda":
        return corr_table_plain(tex_pad, off, nu, t_n, org, n_beams, rows)
    out = _single_table("corr_table_launch", tex_pad, off, nu, t_n, org, n_beams, rows,
                        torch.float32)
    corr_table.launches += 1
    return out


corr_table.launches = 0


def fleet_corr_table_plain(tex_pad, off, nv, t_n, org, n_beams: int, rows: int):
    """Plain PyTorch version of `fleet_corr_table`."""
    return _table_plain(tex_pad, off, nv[:, None].expand(-1, T_MAX), t_n, org, n_beams, rows)


def fleet_corr_table(tex_pad, off, nv, t_n, org, n_beams: int, rows: int):
    """R robots' correlation tables (R, T_MAX, rows, PWIN_C) f32 in one
    launch (the JAX fleet_corr_call, corr_kernel.py:333-374): packed unit
    taps `off` (R, T_MAX * n_beams) int32 from the undeduplicated prepass,
    valid-beam counts `nv` (R,) (every bin has nv taps; 0 taps when nv = 0,
    where the JAX kernel reads one), occupied-bin counts `t_n` (R,) and
    window origins `org` (R, 2) int32 in the shared padded texture.

    Every tap must be a unit tap (w == 1), as the undeduplicated prepass
    makes them: the kernel, like the JAX one, adds each tap's texel and
    reads no weight. Every table cell then equals `_table_in_order` bit
    for bit."""
    t_n = t_n.to(torch.int32)
    _check_taps(tex_pad, torch.float32, off, nv, t_n, org, n_beams, rows,
                (PWIN_R_TIGHT, PWIN_R_NARROW, PWIN_R))
    if tex_pad.device.type != "cuda":
        return fleet_corr_table_plain(tex_pad, off, nv, t_n, org, n_beams, rows)
    tex_pad, off, nv, t_n, org = (t.contiguous() for t in (tex_pad, off, nv, t_n, org))
    n_r = org.shape[0]
    out = torch.empty((n_r, T_MAX, rows, PWIN_C), dtype=torch.float32, device=tex_pad.device)
    _launch("fleet_corr_table_launch", tex_pad, out, tex_pad.data_ptr(), *tex_pad.shape,
            off.data_ptr(), nv.data_ptr(), t_n.data_ptr(), org.data_ptr(), out.data_ptr(),
            n_r, T_MAX, n_beams, rows)
    fleet_corr_table.launches += 1
    return out


fleet_corr_table.launches = 0


def corr_table_q_plain(tex_q, off, nu, t_n, org, n_beams: int, rows: int):
    """Plain PyTorch version of `corr_table_q`."""
    return _table_plain(tex_q, off[None], nu[None], t_n.reshape(1), org[None],
                        n_beams, rows)[0]


def corr_table_q(tex_q, off, nu, t_n, org, n_beams: int, rows: int):
    """`corr_table` over the int8 quantized texture (`build_tex_pad_q`):
    (T_MAX, rows, PWIN_C) int32 exact sums of w * q, rows 32 or 64 (the
    JAX q kernel has no 24-row variant), org = (j0 + PAD_RQ, i0 + PAD_C)."""
    t_n = t_n.to(torch.int32)
    _check_taps(tex_q, torch.int8, off, nu, t_n, org, n_beams, rows,
                (PWIN_R_NARROW, PWIN_R))
    if tex_q.device.type != "cuda":
        return corr_table_q_plain(tex_q, off, nu, t_n, org, n_beams, rows)
    out = _single_table("corr_table_q_launch", tex_q, off, nu, t_n, org, n_beams, rows,
                        torch.int32)
    corr_table_q.launches += 1
    return out


corr_table_q.launches = 0


def table_origin(pre, j0, pad_r: int = PAD_R) -> torch.Tensor:
    """Absolute int32 origin (j0 + pad_r, i0 + PAD_C) of a table window in
    the padded texture: (2,), or (R, 2) for a fleet prepass."""
    return torch.stack([j0 + pad_r, pre["i0"] + PAD_C], dim=-1).to(torch.int32)


def particle_flat(pre, rows: int, j0) -> torch.Tensor:
    """Flat int64 index of each particle's lattice cell in its (T_MAX,
    rows, PWIN_C) table (per robot for a fleet prepass)."""
    dj = (pre["cj"] - j0[..., None]).clamp(0, rows - 1)
    di = (pre["ci"] - pre["i0"][..., None]).clamp(0, PWIN_C - 1)
    return ((pre["t_slot"] * rows + dj) * PWIN_C + di).long()


@dataclasses.dataclass
class Fold:
    """Factor folding into the table read: `combine` maps psi sums to p,
    `factor_tex` is the recalcWeight factor texture, `all_valid` whether
    every particle is on the map (a read bool, or a device flag in a
    capture), `fallback_mf` the per-particle factors for the generic arm."""

    combine: Callable
    factor_tex: torch.Tensor
    all_valid: bool
    fallback_mf: Callable


def _folded_table(corr_s, pre, rows, j0, fold: Fold):
    """combine and the per-cell factor applied TABLE-side: p * factor of
    every lattice cell of the window, (T_MAX, rows, PWIN_C). Valid only
    when every particle is on the map (the factor window is the map's)."""
    jj = (j0 + torch.arange(rows, device=corr_s.device)).long()
    ii = (pre["i0"] + torch.arange(PWIN_C, device=corr_s.device)).long()
    fwin = fold.factor_tex[jj[:, None], ii[None, :]]
    return fold.combine(corr_s) * fwin[None]


def _folded_take(corr_s, pre, rows, j0, fold: Fold):
    """The folded table, then one per-particle take returns p * factor
    (exact: the take picks single elements). Off-map particles need the
    off-map factor, so the fused arm runs only when every particle is on
    the map (recalcWeight, planar_scanner.cpp:646-650)."""
    flat_idx = particle_flat(pre, rows, j0)
    return control.cond(
        fold.all_valid,
        lambda: _folded_table(corr_s, pre, rows, j0, fold).reshape(-1)[flat_idx],
        lambda: fold.combine(corr_s.reshape(-1)[flat_idx]) * fold.fallback_mf(),
        name="corr.all_on_map")


def corr_values(tex_pad, pre, n_beams: int, rows: int, j0, fold: Fold = None):
    """Build the table for one window variant and read each particle's value:
    (M,) psi sums, or with `fold` the final p * factor per particle."""
    corr = corr_table(tex_pad, pre["off"], pre["nu"], pre["t_n"],
                      table_origin(pre, j0), n_beams, rows)
    if fold is not None:
        return _folded_take(corr, pre, rows, j0, fold)
    return corr.reshape(-1)[particle_flat(pre, rows, j0)]


# Flat capacity of the cell-contract table (the standard window's size;
# the narrow and tight tables are zero-padded up to it, corr_kernel.py:953)
T_FLAT_CELLS = T_MAX * PWIN_R * PWIN_C


def corr_cells(tex_pad, pre, n_beams: int, rows: int, j0, fold: Fold):
    """The cell-space twin of `corr_values` with `fold` (corr_kernel.py
    :959-987): (tbl (T_FLAT_CELLS,) f32, key (M,) int64), the folded p *
    factor of every lattice cell of the window, zero-padded, and each
    particle's flat cell in it, with no per-particle take. The caller
    guarantees that every particle is on the map (fold.all_valid) and that
    the cloud fits the window (pre["fits"]): JAX's `ok` flag."""
    corr = corr_table(tex_pad, pre["off"], pre["nu"], pre["t_n"], table_origin(pre, j0),
                      n_beams, rows)
    flat = _folded_table(corr, pre, rows, j0, fold).reshape(-1)
    tbl = torch.nn.functional.pad(flat, (0, T_FLAT_CELLS - flat.numel()))
    return tbl, particle_flat(pre, rows, j0)


def _dequantize(acc, qscale, nv):
    """acc * qstep + nv * qoff with the multiply-add rounded once, as XLA
    fuses it (corr_kernel.py:580-585): the int32 sum times the f32 step and
    the f32 offset are exact in float64, so one rounding to f32 remains."""
    nv_off = nv.to(torch.float32) * qscale[1]
    return (acc.to(torch.float64) * qscale[0].to(torch.float64)
            + nv_off.to(torch.float64)).to(torch.float32)


def corr_values_q(tex_q, qscale, pre, n_beams: int, narrow, fold: Fold = None):
    """`corr_values` over the int8 texture (corr_kernel.py:558-592): the
    narrow (32) or standard (64) window (no tight variant), chosen by a
    `control.cond` on narrow (a read bool, or the device flag in a
    capture), as the JAX package's `lax.cond`; the int32 table dequantized
    as acc * qstep + nv * qoff, per particle or, with `fold`, table-side
    before the fused take."""
    def run(rows, j0):
        corr = corr_table_q(tex_q, pre["off"], pre["nu"], pre["t_n"],
                            table_origin(pre, j0, PAD_RQ), n_beams, rows)
        if fold is not None:
            return _folded_take(_dequantize(corr, qscale, pre["nv"]), pre, rows, j0, fold)
        return _dequantize(corr.reshape(-1)[particle_flat(pre, rows, j0)], qscale, pre["nv"])

    return control.cond(narrow, lambda: run(PWIN_R_NARROW, pre["j0_narrow"]),
                        lambda: run(PWIN_R, pre["j0"]), name="corr_q.window.narrow")
