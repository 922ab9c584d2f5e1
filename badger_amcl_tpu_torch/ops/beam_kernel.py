"""Lattice beam model over the per-angle range image (counterpart of
badger_amcl_tpu.ops.beam_kernel).

On the pose lattice (map cells x adaptive yaw bins) the map range seen by
lattice pose (cell, bin t) through beam b is a texture value
R[k(t, b), j, i], so calcBeamModel (planar_scanner.cpp:168-234) becomes

    corr[t, dj, di] = sum_b  phi_b(min(R[k(t, b), j0+dj, i0+di] * res, range_max))

with phi_b the hit/short/max/rand mixture cubed and k(t, b) =
round((t_min + t_order[t]) * dtheta + a_b) * K / 2pi) mod K. `beam_prepass`
finds the particle window and compacts the occupied yaw bins; `beam_table`
is the kernel wrapper (csrc/beam_table.cu on CUDA tensors,
`beam_table_plain` on CPU tensors); each particle then takes its value.
On the card phi_b is first tabulated per beam over the uint16 range values
(Phi[b, v] for v <= `table_cap`, `beam_value_table_plain` on the CPU), and
the table kernel sums Phi[b, min(R, cap)]: the same values, bit for bit.

Not ported (TPU-only): the per-call XLA `dynamic_slice` of the range image
down to a (K, rows, 128) VMEM window (beam_kernel.py:218-222): each block
of the CUDA kernel stages its window cells' K-vectors from the full image.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.range_image import gather_u16
from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.ops.corr_kernel import (
    MAX_RANGE_CELLS, MIN_RANGE_CELLS, PWIN_C, PWIN_R, PWIN_R_NARROW, PWIN_R_TIGHT, T_MAX,
    _compaction, particle_flat,
)
from badger_amcl_tpu_torch.utils.numerics import fdiv

# the TPU kernel's VMEM budget for its (K, 64, 128) u16 window, kept as the
# dispatch predicate (beam_kernel.py:53)
MAX_RI_BYTES = 6 * 1024 * 1024


def ri_fits(omap) -> bool:
    """The JAX package's static gate (beam_kernel.py:191-199)."""
    if omap.range_image is None:
        return False
    k = omap.range_image.shape[0]
    return (k * PWIN_R * PWIN_C * 2 <= MAX_RI_BYTES and omap.size_y >= PWIN_R
            and omap.size_x >= PWIN_C)


def dtheta(omap, range_max: float) -> float:
    """Adaptive yaw-bin width, f32: one cell of arc at range_max, the
    longest return the range image can produce (beam_kernel.py:56-60)."""
    f32 = np.float32
    cells = np.clip(f32(range_max) / f32(omap.resolution), f32(MIN_RANGE_CELLS),
                    f32(MAX_RANGE_CELLS))
    return float(f32(1.0) / f32(cells))


@functools.lru_cache(maxsize=None)
def bin_inv(k_angles: int) -> float:
    """K / 2pi in f32, as the TPU kernel computes it."""
    return float(np.float32(k_angles) / np.float32(2.0 * np.pi))


def beam_prepass(omap, spose, range_max: float):
    """Particle window, adaptive yaw bins and their compaction
    (beam_kernel.py:140-188); flags and window origins stay on the device."""
    dev = spose.device
    ci, cj = omap.cells_of(spose[:, 0], spose[:, 1])
    ci = ci.clamp(0, omap.size_x - 1)
    cj = cj.clamp(0, omap.size_y - 1)
    i0 = ci.min()
    j0_raw = cj.min()
    row_span = cj.max() - j0_raw
    span_ok = (ci.max() - i0 < PWIN_C) & (row_span < PWIN_R)
    narrow_ok = span_ok & (row_span < PWIN_R_NARROW) & (omap.size_y >= PWIN_R_NARROW)
    tight_ok = span_ok & (row_span < PWIN_R_TIGHT) & (omap.size_y >= PWIN_R_TIGHT)
    # each window variant clips from the raw origin
    i0 = i0.clamp(0, max(omap.size_x - PWIN_C, 0))
    j0 = j0_raw.clamp(0, max(omap.size_y - PWIN_R, 0))
    j0_n = j0_raw.clamp(0, max(omap.size_y - PWIN_R_NARROW, 0))
    j0_t = j0_raw.clamp(0, max(omap.size_y - PWIN_R_TIGHT, 0))
    dth = dtheta(omap, range_max)
    t_m = torch.round(fdiv(spose[:, 2], dth)).to(torch.int32)
    t_min = t_m.min()
    t_count = t_m.max() - t_min + 1
    t_rel = (t_m - t_min).clamp(0, T_MAX - 1)
    t_occ = torch.zeros((T_MAX,), dtype=torch.bool, device=dev).scatter_(0, t_rel.long(), True)
    t_n = t_occ.sum().to(torch.int32)
    t_dest, t_order = _compaction(t_occ, t_n)
    return {"ci": ci, "cj": cj, "i0": i0, "j0": j0, "j0_narrow": j0_n, "j0_tight": j0_t,
            "narrow": narrow_ok, "tight": tight_ok, "t_min": t_min.to(torch.int32),
            "t_count": t_count, "fits": span_ok & (t_count <= T_MAX), "dtheta": dth,
            "t_slot": t_dest[t_rel.long()], "t_n": t_n, "t_order": t_order}


@dataclasses.dataclass(frozen=True)
class BeamMix:
    """The beam mixture's constants, each rounded to f32 as the TPU kernel's
    `mix` vector (beam_kernel.py:207-213)."""

    z_hit: float
    z_short: float
    z_max: float
    z_rand_mult: float  # z_rand / range_max
    range_max: float
    denom_inv: float  # 1 / (2 sigma_hit^2)
    lam: float  # lambda_short
    res: float
    denom: float  # 2 sigma_hit^2

    @staticmethod
    def of(params, range_max: float, resolution: float) -> "BeamMix":
        f32 = np.float32
        denom = 2.0 * params.sigma_hit * params.sigma_hit
        return BeamMix(*(float(f32(v)) for v in (
            params.z_hit, params.z_short, params.z_max,
            f32(params.z_rand) / f32(range_max), range_max, 1.0 / denom,
            params.lambda_short, resolution, denom)))


def beam_pz3(mix: BeamMix, obs, r, divide: bool = False) -> torch.Tensor:
    """pz^3 of calcBeamModel's hit/short/max/rand mixture
    (planar_scanner.cpp:168-234) at observed ranges `obs` and map ranges
    `r` (broadcast). The hit exponent is multiplied by denom_inv, as the
    TPU kernel does, or with `divide` divided by the denominator, as the
    JAX package's XLA arms do."""
    z = obs - r
    e = fdiv(-(z * z), mix.denom) if divide else -(z * z) * mix.denom_inv
    pz = mix.z_hit * torch.exp(e)
    pz = pz + torch.where(z < 0, mix.z_short * mix.lam * torch.exp(-mix.lam * obs), 0.0)
    pz = pz + torch.where(obs == mix.range_max, mix.z_max, 0.0)
    pz = pz + torch.where(obs < mix.range_max, mix.z_rand_mult, 0.0)
    return pz * pz * pz


def slab_indices(t_min, t_order, angles, dth: float, k_angles: int) -> torch.Tensor:
    """k(t, b) (T, B) int64: the range-image slab slot t reads for beam b,
    round_half_even(((t_min + t_order[t]) * dtheta + a_b) * bin_inv) mod K."""
    theta = (t_min + t_order).to(torch.float32) * dth  # (T,)
    kk = torch.round((theta[:, None] + angles[None, :]) * bin_inv(k_angles))
    return torch.remainder(kk.to(torch.int64), k_angles)


def beam_table_plain(rimg, obs, angles, t_n, t_min, t_order, org, mix: BeamMix,
                     dth: float, rows: int):
    """Plain PyTorch version of the kernel: (T_MAX, rows, PWIN_C) f32, slots
    t >= max(t_n, 1) zero; beams summed in ascending order, each op rounded
    as the kernel rounds it."""
    dev = rimg.device
    t_max = t_order.shape[0]
    kk = slab_indices(t_min, t_order, angles, dth, rimg.shape[0])  # (T, B)
    jj = (org[0] + torch.arange(rows, device=dev)).long()
    ii = (org[1] + torch.arange(PWIN_C, device=dev)).long()
    win = gather_u16(rimg, slice(None), jj[:, None], ii[None, :])  # (K, rows, PWIN_C)
    acc = torch.zeros((t_max, rows, PWIN_C), dtype=torch.float32, device=dev)
    for b in range(obs.shape[0]):
        r = torch.clamp(win[kk[:, b]].to(torch.float32) * mix.res, max=mix.range_max)
        acc = acc + beam_pz3(mix, obs[b], r)
    live = torch.arange(t_max, device=dev) < torch.clamp(t_n, min=1)
    return torch.where(live[:, None, None], acc, 0.0)


@functools.lru_cache(maxsize=64)
def table_cap(mix: BeamMix) -> int:
    """The smallest v with f32(v) * res >= range_max in f32 (65535 if no
    uint16 v reaches it): min(v * res, range_max) is range_max for every
    v >= cap."""
    res, rmax = np.float32(mix.res), np.float32(mix.range_max)
    v = max(int(np.ceil(float(rmax) / float(res))) - 2, 0)
    while v <= 65535 and np.float32(v) * res < rmax:
        v += 1
    while v > 0 and np.float32(v - 1) * res >= rmax:
        v -= 1
    return min(v, 65535)


def beam_value_table_plain(obs, mix: BeamMix, cap: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's value table: (B, cap + 1) f32,
    Phi[b, v] = beam_pz3 at obs[b] and min(f32(v) * res, range_max)."""
    v = torch.arange(cap + 1, dtype=torch.float32, device=obs.device)
    m = torch.minimum(v * mix.res, torch.tensor(mix.range_max, device=obs.device))
    return beam_pz3(mix, obs[:, None], m[None, :])


# the table kernel stages each window cell's K-vector in shared memory
MAX_ANGLES = 4096


@functools.lru_cache(maxsize=64)
def _launch_consts(mix: BeamMix, dth: float, k_angles: int):
    """(cap, the kernel's BeamConsts) of a mixture, bin width and K, built
    once: the beam cells are host-bound, and 10 float arguments fewer
    shorten every launch call."""
    return table_cap(mix), _build.BeamConsts(
        mix.z_hit, mix.z_short, mix.z_max, mix.z_rand_mult, mix.range_max, mix.denom_inv,
        mix.lam, mix.res, dth, bin_inv(k_angles))


def beam_table(rimg, obs, angles, t_n, t_min, t_order, org, mix: BeamMix, dth: float,
               rows: int):
    """The beam correlation table (T_MAX, rows, PWIN_C) f32 over the range
    image `rimg` uint16 (K, H, W): observed ranges and bearings `obs`,
    `angles` (B,) f32, occupied-bin count `t_n` and first raw bin `t_min`
    (0-dim int32), slot -> raw bin offset `t_order` (T_MAX,) int32, window
    origin `org` (2,) int32 = (j0, i0) in the image. On the card one call
    launches the value table, then the table kernel's lookups."""
    if rimg.dim() != 3 or rimg.dtype != torch.uint16:
        raise ValueError("the range image must be (K, H, W) uint16")
    if obs.shape != angles.shape or obs.dim() != 1 or obs.dtype != torch.float32 \
            or angles.dtype != torch.float32:
        raise ValueError("obs and angles must be matching (B,) float32 vectors")
    if t_order.shape != (T_MAX,) or t_order.dtype != torch.int32:
        raise ValueError("t_order must be (T_MAX,) int32")
    if org.shape != (2,) or org.dtype != torch.int32:
        raise ValueError("org must be a (2,) int32 origin")
    if t_n.dtype != torch.int32 or t_min.dtype != torch.int32:
        raise ValueError("t_n and t_min must be 0-dim int32")
    if rows not in (PWIN_R_TIGHT, PWIN_R_NARROW, PWIN_R):
        raise ValueError(f"rows must be one of 24, 32, 64, got {rows}")
    if rimg.shape[0] > MAX_ANGLES:
        raise ValueError(f"the range image has {rimg.shape[0]} > {MAX_ANGLES} angle bins")
    if rimg.device.type != "cuda":
        return beam_table_plain(rimg, obs, angles, t_n, t_min, t_order, org, mix, dth,
                                rows)
    index = rimg.get_device()
    for t in (obs, angles, t_n, t_min, t_order, org):
        if t.get_device() != index:
            raise ValueError("all inputs must be on one device")
    if obs.shape[0] == 0:
        return torch.zeros((T_MAX, rows, PWIN_C), dtype=torch.float32, device=rimg.device)
    k_angles, h, w = rimg.shape
    cap, consts = _launch_consts(mix, dth, k_angles)
    n_out = T_MAX * rows * PWIN_C
    # one allocation: the table, then the kernel's scratch (the value table,
    # its rows padded to a multiple of 4 floats, and the uint16 slab table)
    buf = torch.empty((n_out + obs.shape[0] * (((cap + 4) & ~3) + T_MAX // 2),),
                      dtype=torch.float32, device=rimg.device)
    code = _build.lib().beam_table_launch(
        rimg.contiguous().data_ptr(), k_angles, h, w, obs.contiguous().data_ptr(),
        angles.contiguous().data_ptr(), obs.shape[0], t_n.data_ptr(), t_min.data_ptr(),
        t_order.contiguous().data_ptr(), org.contiguous().data_ptr(), consts,
        buf.data_ptr() + 4 * n_out, cap, buf.data_ptr(), T_MAX, rows,
        _build.stream_ptr(rimg.device))
    _build.check(code, "beam_table")
    out = buf[:n_out].view(T_MAX, rows, PWIN_C)
    beam_table.launches += 1
    return out


beam_table.launches = 0


def window_origin(pre, j0) -> torch.Tensor:
    """(2,) int32 (j0, i0) of a window variant in the range image."""
    return torch.stack([j0, pre["i0"]]).to(torch.int32)


def beam_corr_values(omap, params, scan, pre, rows: int, j0) -> torch.Tensor:
    """p_model (M,) = 1 + the table at each particle's lattice pose, for the
    window variant (rows, j0) picked by the caller."""
    mix = BeamMix.of(params, scan.range_max, omap.resolution)
    corr = beam_table(omap.range_image, scan.ranges.to(torch.float32),
                      scan.angles.to(torch.float32), pre["t_n"], pre["t_min"],
                      pre["t_order"], window_origin(pre, j0), mix, pre["dtheta"], rows)
    return 1.0 + corr.reshape(-1)[particle_flat(pre, rows, j0)]
