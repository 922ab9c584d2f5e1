"""Per-particle beam-term sums for SPREAD particle clouds (counterpart of
badger_amcl_tpu.ops.spread_kernel).

Distances are read from the int8 ratio-quantized texture (`quantized_tex`:
max_distance/127 levels, off-map = max_distance — the 2D twin of the 3D
path's uint8 contract; baked once into the map's `distances_q` with its
distance field) at the endpoint cell floor(pxc + rca*ct - rsa*st),
the TPU kernel's own formula. `spread_term_sums` is the kernel wrapper:
CUDA tensors launch csrc/spread_term_sums.cu, which looks each pair's beam
term (`BeamTerm`: pz^3, pz or log pz) up in `term_table`; CPU tensors run
`spread_term_sums_plain`, which takes any elementwise term.

Not ported (TPU-only machinery): the yaw/block particle sort, the window
tiers and their prepass, the capacity-bounded escape arm and `unsort`. The
direct gather covers every (particle, beam) pair, so the JAX dispatch's
escape-overflow fallback has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.utils.numerics import fdiv

QLEVELS = 127.0
MAX_TEX_CELLS = 4 * 1024 * 1024
ROWS1 = 224
LOAD_C1 = 256 + 128


def tex_fits(omap) -> bool:
    """The JAX package's static gate for its spread kernel (texture within
    its VMEM budget, map at least one window) — kept as the dispatch
    predicate so the port takes the same arm."""
    return (omap.size_x * omap.size_y <= MAX_TEX_CELLS
            and omap.size_y >= ROWS1 and omap.size_x >= LOAD_C1)


def quantized_tex(omap) -> torch.Tensor:
    """The int8 ratio-quantized distance texture (spread_kernel.py:161-165)."""
    return torch.round(
        omap.distances * (QLEVELS / omap.max_distance_to_object)).to(torch.int8)


# the beam terms' forms: likelihood field, Gompertz, prob
TERM_FORMS = ("cube", "pz", "log")


@dataclasses.dataclass(frozen=True)
class BeamTerm:
    """Beam term of a likelihood-field model at endpoint distance z, with
    pz = z_hit exp(-z^2 / denom) + zr: pz^3 for likelihood_field
    (planar_scanner.cpp:236-323, zr = z_rand / range_max), pz for the
    Gompertz model (:552-640, zr = z_rand raw), log pz for the prob model
    (:325-533, zr = z_rand / range_max)."""

    z_hit: float
    denom: float
    zr: float
    form: str = "cube"

    def __post_init__(self):
        if self.form not in TERM_FORMS:
            raise ValueError(f"form must be one of {TERM_FORMS}, got {self.form!r}")

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        pz = self.z_hit * torch.exp(fdiv(-(z * z), self.denom)) + self.zr
        if self.form == "cube":
            return pz * pz * pz
        return pz if self.form == "pz" else torch.log(pz)


@functools.lru_cache(maxsize=64)
def term_table(term: BeamTerm, max_d: float, device: torch.device) -> torch.Tensor:
    """(257,) f32: `term` at z = q * (max_d / QLEVELS) for the int8 levels
    q = -128..127, then at z = max_d (off the map): the plain version's own
    expression on the same device, so a lookup gives its term bit for bit.
    Cached per (term, max_d, device)."""
    q = torch.arange(-128, 128, dtype=torch.float32, device=device)
    z = torch.cat([q * (max_d / QLEVELS),
                   torch.full((1,), max_d, dtype=torch.float32, device=device)])
    return term(z).contiguous()


def endpoint_inputs(omap, spose, ranges, angles):
    """Per-particle cell-space positions and cos/sin, per-beam r*cos(a)/res
    and r*sin(a)/res (spread_kernel.py:511-521)."""
    pxc = fdiv(spose[:, 0] - omap.origin_x, omap.resolution) + (0.5 + omap.size_x // 2)
    pyc = fdiv(spose[:, 1] - omap.origin_y, omap.resolution) + (0.5 + omap.size_y // 2)
    ct, st = torch.cos(spose[:, 2]), torch.sin(spose[:, 2])
    inv_res = float(np.float32(1.0 / omap.resolution))
    r = ranges.to(torch.float32)
    a = angles.to(torch.float32)
    rca = r * torch.cos(a) * inv_res
    rsa = r * torch.sin(a) * inv_res
    return pxc, pyc, ct, st, rca, rsa


def spread_term_sums_plain(omap, qtex, pxc, pyc, ct, st, rca, rsa, valid, term):
    """Plain PyTorch version: (M,) sums over valid beams of term(z)."""
    ci = torch.floor(pxc[None, :] + rca[:, None] * ct[None, :]
                     - rsa[:, None] * st[None, :]).to(torch.int32)
    cj = torch.floor(pyc[None, :] + rsa[:, None] * ct[None, :]
                     + rca[:, None] * st[None, :]).to(torch.int32)
    maxd = omap.max_distance_to_object
    q = qtex.reshape(-1)[omap.flat_index(ci, cj)].to(torch.float32)
    z = torch.where(omap.in_bounds(ci, cj), q * (maxd / QLEVELS),
                    torch.full_like(q, maxd))
    return torch.where(valid[:, None], term(z), 0.0).sum(dim=0)


def _prep(omap, spose, ranges, angles, stream):
    """Launch the CUDA prepass: a (4 M + 2 B,) f32 buffer holding pxc, pyc,
    ct, st, rca and rsa, and their six device pointers."""
    m, b = spose.shape[0], ranges.shape[0]
    spose = spose.contiguous()
    ranges = ranges.to(torch.float32).contiguous()
    angles = angles.to(torch.float32).contiguous()
    buf = torch.empty((4 * m + 2 * b,), dtype=torch.float32, device=spose.device)
    p0 = buf.data_ptr()
    ptrs = [p0 + 4 * k * m for k in range(5)] + [p0 + 4 * (4 * m + b)]
    # 1 / res rounded to f32, as endpoint_inputs takes it
    inv_res = float(np.float32(1.0 / omap.resolution))
    code = _build.lib().spread_prep_launch(
        spose.data_ptr(), m, ranges.data_ptr(), angles.data_ptr(), b, omap.origin_x,
        omap.origin_y, omap.resolution, 0.5 + omap.size_x // 2, 0.5 + omap.size_y // 2,
        inv_res, *ptrs, stream)
    _build.check(code, "spread_prep")
    return buf, ptrs


def endpoint_inputs_cuda(omap, spose, ranges, angles):
    """`endpoint_inputs` on the card in one launch of the CUDA prepass,
    which rounds as their torch expressions do."""
    m, b = spose.shape[0], ranges.shape[0]
    buf, _ = _prep(omap, spose, ranges, angles, _build.stream_ptr(spose.device))
    return tuple(buf[k * m:(k + 1) * m] for k in range(4)) + (buf[4 * m:4 * m + b],
                                                               buf[4 * m + b:])


def spread_term_sums(omap, spose, ranges, angles, valid, term):
    """Per-particle sums of term(distance) over valid beams, (M,) f32 in
    particle order. On the card: the CUDA prepass (`endpoint_inputs_cuda`),
    then the term sums over the baked texture and `term_table`."""
    if spose.dim() != 2 or spose.shape[1] != 3 or spose.dtype != torch.float32:
        raise ValueError("spose must be (M, 3) float32")
    if not (ranges.shape == angles.shape == valid.shape) or ranges.dim() != 1:
        raise ValueError("ranges, angles and valid must be matching (B,) vectors")
    qtex = omap.distances_q
    if qtex is None:
        raise ValueError("the map has no quantized distance texture (with_distance_field)")
    if spose.device.type != "cuda":
        return spread_term_sums_plain(omap, qtex, *endpoint_inputs(omap, spose, ranges, angles),
                                      valid, term)
    if not isinstance(term, BeamTerm):
        raise TypeError("the CUDA spread kernel computes a BeamTerm only")
    for t in (ranges, angles, valid, qtex):
        if t.device != spose.device:
            raise ValueError("all inputs must be on one device")
    m, b = spose.shape[0], ranges.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=spose.device)
    if m == 0:
        return out
    stream = _build.stream_ptr(spose.device)
    buf, (pxc, pyc, ct, st, rca, rsa) = _prep(omap, spose, ranges, angles, stream)
    table = term_table(term, omap.max_distance_to_object, spose.device)
    valid = valid.to(torch.bool).contiguous()
    code = _build.lib().spread_term_sums_launch(
        qtex.data_ptr(), omap.size_y, omap.size_x, pxc, pyc, ct, st, m, rca, rsa,
        valid.data_ptr(), b, table.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "spread_term_sums")
    spread_term_sums.launches += 1
    return out


spread_term_sums.launches = 0
