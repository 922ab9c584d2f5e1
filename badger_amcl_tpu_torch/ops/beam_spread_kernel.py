"""Beam-model likelihood for SPREAD particle clouds (counterpart of
badger_amcl_tpu.ops.beam_spread_kernel).

Beam b of particle p reads the range image at the particle's own cell,
R[k(p, b), j_p, i_p], with k(p, b) ~ sigma_p + kappa_b (mod K), sigma_p =
round(theta_p K / 2pi) and kappa_b = round(a_b K / 2pi), each rounded
(beam_spread_kernel.py:16-22). So a particle's reads all lie in one
K-vector of the transposed image `range_rows` (H * W, K), and beams that
share an offset kappa merge into one table row

    Phi[g, v] = sum over beams with kappa_b == g of pz_b(min(v res, range_max))^3

(`phi_tables`, beam_spread_kernel.py:225-260). The likelihood is then
p = 1 + sum over occupied offsets g of Phi[g, min(R_rows[cell_p, (sigma_p + g)
mod K], cap)]. `beam_spread_sums` is the kernel wrapper (csrc/
beam_spread_sums.cu on CUDA tensors, `beam_spread_sums_plain` on CPU
tensors).

Not ported (TPU-only machinery): the sigma sort, the 1024-particle tiles
and their distinct-slab lists, the doubled slab axis, the one-hot MXU
contraction and `unsort` (beam_spread_kernel.py:160-222, :290-293). The
kernel takes particles in draw order and wraps (sigma + g) mod K itself.
"""

from __future__ import annotations

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.range_image import gather_u16
from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.ops.beam_kernel import BeamMix, beam_pz3, bin_inv
from badger_amcl_tpu_torch.ops.corr_kernel import _compaction

V = 256  # range-value table size (cells); needs range_max / res < V
# the JAX package's HBM budget for the transposed bake (1024^2 x 256 is
# 512 MiB), kept as the bake gate (beam_spread_kernel.py:77)
RANGE_ROWS_MAX_BYTES = 768 << 20


def fits(omap, range_max: float) -> bool:
    """The value table covers every range the image can return
    (beam_spread_kernel.py:215)."""
    return bool(np.float32(range_max) / np.float32(omap.resolution) < V)


def value_cap(omap, range_max: float) -> int:
    """min(round(range_max / res), V - 1), in f32 as the JAX package."""
    return int(min(np.round(np.float32(range_max) / np.float32(omap.resolution)), V - 1))


def beam_spread_prepass(omap, spose, angles):
    """Each particle's flat cell (clipped to the map) and slab sigma, and
    the beams' occupied slab offsets compacted to the front (`gocc`, with
    their count `n_g` on the device) plus each beam's offset `kap`."""
    k = int(omap.range_image.shape[0])
    ci, cj = omap.cells_of(spose[:, 0], spose[:, 1])
    ci = ci.clamp(0, omap.size_x - 1)
    cj = cj.clamp(0, omap.size_y - 1)
    binv = bin_inv(k)
    sig = torch.remainder(torch.round(spose[:, 2] * binv).to(torch.int32), k)
    kap = torch.remainder(torch.round(angles.to(torch.float32) * binv).to(torch.int32), k)
    occ = torch.zeros((k,), dtype=torch.bool, device=spose.device).scatter_(0, kap.long(), True)
    n_g = occ.sum().to(torch.int32)
    _, gocc = _compaction(occ, n_g)
    return {"flat": (cj.to(torch.int64) * omap.size_x + ci).contiguous(),
            "sig": sig.to(torch.int32).contiguous(), "kap": kap, "gocc": gocc,
            "n_g": n_g}


def phi_tables(omap, params, scan, kap) -> torch.Tensor:
    """(K, V) f32: Phi[g, v] = sum over beams with offset g of pz(obs_b,
    min(v res, range_max))^3 (beam_spread_kernel.py:225-260). The segment
    sum is an f32 accumulating `index_put_` — never TF32, unlike a matmul;
    on CUDA it sorts the beams by offset (stably) and adds each row's beams
    in one fixed order, so every run gives the same Phi (an `index_add_`'s
    atomics would not, and the weights and picks that follow would differ
    between runs). A NaN range poisons its row, which every particle reads:
    calcBeamModel has no NaN-beam skip, and a NaN makes every particle's p
    NaN, as in the exact arm."""
    k = int(omap.range_image.shape[0])
    dev = scan.ranges.device
    mix = BeamMix.of(params, scan.range_max, omap.resolution)
    obs = scan.ranges.to(torch.float32)[:, None]  # (B, 1)
    m_v = torch.clamp(torch.arange(V, dtype=torch.float32, device=dev) * mix.res,
                      max=mix.range_max)[None, :]  # (1, V)
    phi = torch.zeros((k, V), dtype=torch.float32, device=dev)
    return phi.index_put_((kap.long(),), beam_pz3(mix, obs, m_v, divide=True),
                          accumulate=True)


def beam_spread_sums_plain(range_rows, flat, sig, gocc, n_g, phi, cap: int):
    """Plain PyTorch version of the kernel: (M,) f32, per particle the sum
    over occupied offsets g, ascending, of Phi[g, min(v, cap)]."""
    k = range_rows.shape[1]
    dev = range_rows.device
    occ = torch.arange(k, device=dev) < n_g
    g = gocc.long()
    rows = gather_u16(range_rows, flat)  # (M, K)
    slab = torch.remainder(sig.long()[:, None] + g[None, :], k)  # (M, K)
    v = torch.gather(rows, 1, slab).clamp(max=cap).long()
    vals = phi[g[None, :], v]  # (M, K)
    acc = torch.zeros((flat.shape[0],), dtype=torch.float32, device=dev)
    for j in range(k):
        acc = acc + torch.where(occ[j], vals[:, j], 0.0)
    return acc


def beam_spread_sums(range_rows, flat, sig, gocc, n_g, phi, cap: int):
    """Per-particle sums (M,) f32 in draw order over the transposed range
    image `range_rows` uint16 (H * W, K): particles' flat cells `flat` (M,)
    int64 and slabs `sig` (M,) int32, occupied offsets `gocc` (K,) int32
    (the first `n_g` of them, 0-dim int32 on the device), tables `phi`
    (K, V) f32, value cap `cap`."""
    if range_rows.dim() != 2 or range_rows.dtype != torch.uint16:
        raise ValueError("range_rows must be (H * W, K) uint16")
    k = range_rows.shape[1]
    if phi.shape != (k, V) or phi.dtype != torch.float32:
        raise ValueError(f"phi must be ({k}, {V}) float32")
    if flat.dtype != torch.int64 or sig.dtype != torch.int32 or flat.shape != sig.shape:
        raise ValueError("flat must be int64 and sig int32, both (M,)")
    if gocc.shape != (k,) or gocc.dtype != torch.int32:
        raise ValueError("gocc must be (K,) int32")
    if not 0 <= cap < V:
        raise ValueError(f"cap must be in [0, {V})")
    if range_rows.device.type != "cuda":
        return beam_spread_sums_plain(range_rows, flat, sig, gocc, n_g, phi, cap)
    for t in (flat, sig, gocc, n_g, phi):
        if t.device != range_rows.device:
            raise ValueError("all inputs must be on one device")
    m = flat.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=range_rows.device)
    if m == 0:
        return out
    n_g = n_g.to(torch.int32).reshape(1).contiguous()
    code = _build.lib().beam_spread_sums_launch(
        range_rows.contiguous().data_ptr(), k, flat.contiguous().data_ptr(),
        sig.contiguous().data_ptr(), m, gocc.contiguous().data_ptr(), n_g.data_ptr(),
        phi.contiguous().data_ptr(), V, cap, out.data_ptr(),
        _build.stream_ptr(range_rows.device))
    _build.check(code, "beam_spread_sums")
    beam_spread_sums.launches += 1
    return out


beam_spread_sums.launches = 0


def beam_spread_values(omap, params, scan, spose) -> torch.Tensor:
    """p_model (M,) = 1 + the per-particle sums, in draw order."""
    pre = beam_spread_prepass(omap, spose, scan.angles)
    phi = phi_tables(omap, params, scan, pre["kap"])
    return 1.0 + beam_spread_sums(omap.range_rows, pre["flat"], pre["sig"], pre["gocc"],
                                  pre["n_g"], phi, value_cap(omap, scan.range_max))
