"""Distance-field lookups at every scan endpoint (counterpart of
badger_amcl_tpu.ops.lf_kernel).

Kernel wrappers (CUDA tensors launch csrc/lf_distances.cu, CPU tensors run
the plain version beside each):
- `lf_distances`: the (B, M) distances, the counterpart of the JAX
  package's `lf_distances_t` (no main path of the port launches it);
- `lf_term_sums`: per particle the sum over the beams of a (B,) mask of a
  `BeamTerm` of the distance, (M,), fused: nothing (B, M) is materialized;
- `beam_extents`: the window prepass's per-beam extents of the in-map
  endpoint cells, which `window_finish` turns into the TPU kernel's
  window origins and its fits flag (`window_origins`);
- `lf_obs_counts`: beam skipping's per-beam count of the active particles
  whose in-map endpoint lies within the skip distance of the map, (B,).

`with_lf_texture` keeps the JAX package's contract: where its windowed
TPU kernel would run (every beam's endpoints fit a WIN_ROWS x WIN_COLS
window) the texture is read in bf16 (the map's baked `distances_bf16`),
which is what that kernel returns; elsewhere in f32, the JAX package's
exact gather: a `utils.control.cond` on the fits flag, as the JAX
package's `lax.cond` (lf_kernel.py:224). `lf_texture` hands back the
texture itself after a host read (eager use only). The per-beam windows
themselves are not ported: a GPU gathers directly.
"""

from __future__ import annotations

import torch

from badger_amcl_tpu_torch.ops import _build
from badger_amcl_tpu_torch.ops.spread_kernel import TERM_FORMS, BeamTerm
from badger_amcl_tpu_torch.utils import control

WIN_ROWS = 64
WIN_COLS = 256
BIG = 1 << 30  # the extent of a beam without an in-map endpoint


def _check_poses_beams(spose, ranges, angles):
    if spose.dim() != 2 or spose.shape[1] != 3 or spose.dtype != torch.float32:
        raise ValueError("spose must be (M, 3) float32")
    if ranges.shape != angles.shape or ranges.dim() != 1:
        raise ValueError("ranges and angles must be matching (B,) vectors")


def _geometry(omap):
    """The map geometry every entry point takes after its pointers."""
    return (omap.resolution, omap.origin_x, omap.origin_y, omap.size_x // 2,
            omap.size_y // 2, omap.size_x, omap.size_y)


def _pose_beam_ptrs(spose, ranges, angles):
    """Contiguous poses (M, 3), ranges and angles (kept alive by the
    caller)."""
    return (spose.contiguous(), ranges.to(torch.float32).contiguous(),
            angles.to(torch.float32).contiguous())


def _endpoint_cells(omap, spose, ranges, angles):
    """(B, M) int32 endpoint cells (ci, cj)."""
    th = spose[None, :, 2] + angles[:, None]
    hx = spose[None, :, 0] + ranges[:, None] * torch.cos(th)
    hy = spose[None, :, 1] + ranges[:, None] * torch.sin(th)
    return omap.cells_of(hx, hy)


def beam_extents_plain(omap, spose, ranges, angles):
    """Plain PyTorch version of the prepass kernel: (4, B) int32 rows
    ci_min, ci_max, cj_min, cj_max over each beam's in-map endpoint cells,
    +-BIG for a beam with none (lf_kernel.py:108-125)."""
    ci, cj = _endpoint_cells(omap, spose, ranges, angles)
    inmap = omap.in_bounds(ci, cj)
    return torch.stack([torch.where(inmap, ci, BIG).min(dim=1).values,
                        torch.where(inmap, ci, -BIG).max(dim=1).values,
                        torch.where(inmap, cj, BIG).min(dim=1).values,
                        torch.where(inmap, cj, -BIG).max(dim=1).values]).to(torch.int32)


def beam_extents(omap, spose, ranges, angles):
    """The per-beam extents (4, B) int32 of `beam_extents_plain`: one call
    of the CUDA prepass (two launches) on CUDA tensors."""
    _check_poses_beams(spose, ranges, angles)
    if spose.device.type != "cuda":
        return beam_extents_plain(omap, spose, ranges, angles)
    for t in (ranges, angles):
        if t.device != spose.device:
            raise ValueError("all inputs must be on one device")
    m, b = spose.shape[0], ranges.shape[0]
    ext = torch.empty((4, b), dtype=torch.int32, device=spose.device)
    if b == 0:
        return ext
    p, r, a = _pose_beam_ptrs(spose, ranges, angles)
    code = _build.lib().lf_extents_launch(
        p.data_ptr(), m, r.data_ptr(), a.data_ptr(), b,
        *_geometry(omap), ext.data_ptr(), _build.stream_ptr(spose.device))
    _build.check(code, "lf_extents")
    beam_extents.launches += 1
    return ext


beam_extents.launches = 0


def window_finish(omap, ext):
    """Per-beam window origins (row0, col0) and the global fits flag of the
    TPU kernel's windows, with its (8, 128) alignment, from the extents
    (lf_kernel.py:126-133): fits is judged on the unclamped origins."""
    ci_min, ci_max, cj_min, cj_max = ext.unbind(0)
    row0 = torch.where(cj_min == BIG, 0, cj_min) & ~7
    col0 = torch.where(ci_min == BIG, 0, ci_min) & ~127
    fits = torch.all(((ci_max - col0) < WIN_COLS) & ((cj_max - row0) < WIN_ROWS))
    row0 = row0.clamp(0, omap.size_y - WIN_ROWS) & ~7
    col0 = col0.clamp(0, omap.size_x - WIN_COLS) & ~127
    return row0.to(torch.int32), col0.to(torch.int32), fits


def window_origins(omap, spose, ranges, angles):
    """Per-beam window origins (row0, col0) and the global fits flag of the
    TPU kernel's windows (lf_kernel.py:108-133)."""
    return window_finish(omap, beam_extents(omap, spose, ranges, angles))


def lf_distances_plain(omap, tex, spose, ranges, angles):
    """Plain PyTorch version of the kernel: (B, M) f32 texture values at the
    endpoints, off-map -> max distance."""
    ci, cj = _endpoint_cells(omap, spose, ranges, angles)
    d = tex.reshape(-1)[omap.flat_index(ci, cj)].to(torch.float32)
    return torch.where(omap.in_bounds(ci, cj), d,
                       torch.full_like(d, omap.max_distance_to_object))


def _check_texture(omap, tex):
    if tex.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"texture must be float32 or bfloat16, got {tex.dtype}")
    if tuple(tex.shape) != (omap.size_y, omap.size_x):
        raise ValueError(f"texture shape {tuple(tex.shape)} != map "
                         f"{(omap.size_y, omap.size_x)}")


def lf_distances(omap, tex, spose, ranges, angles):
    """(B, M) f32 values of `tex` ((H, W) f32 or bf16) at every endpoint."""
    _check_texture(omap, tex)
    _check_poses_beams(spose, ranges, angles)
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
    p, r, a = _pose_beam_ptrs(spose, ranges, angles)
    lib = _build.lib()
    fn = lib.lf_distances_bf16_launch if tex.dtype == torch.bfloat16 \
        else lib.lf_distances_f32_launch
    code = fn(tex.data_ptr(), p.data_ptr(), m, r.data_ptr(),
              a.data_ptr(), b, *_geometry(omap), omap.max_distance_to_object, out.data_ptr(),
              _build.stream_ptr(spose.device))
    _build.check(code, "lf_distances")
    lf_distances.launches += 1
    return out


lf_distances.launches = 0


def lf_obs_counts_plain(omap, tex, spose, ranges, angles, valid, active, skip_distance):
    """Plain PyTorch version of the counts kernel: (B,) int32, per valid
    beam the active particles whose endpoint cell is on the map and reads
    a value below skip_distance (planar_scanner.cpp:441-453)."""
    ci, cj = _endpoint_cells(omap, spose, ranges, angles)
    d = tex.reshape(-1)[omap.flat_index(ci, cj)].to(torch.float32)
    agrees = omap.in_bounds(ci, cj) & (d < skip_distance) & valid[:, None] & active[None, :]
    return agrees.sum(dim=1).to(torch.int32)


def lf_obs_counts(omap, tex, spose, ranges, angles, valid, active, skip_distance):
    """Beam skipping's per-beam agreement counts (B,) int32 of
    `lf_obs_counts_plain` over the values of `tex` ((H, W) f32 or bf16):
    one launch on CUDA tensors, nothing (B, M) in memory. skip_distance is
    compared in f32."""
    _check_texture(omap, tex)
    _check_poses_beams(spose, ranges, angles)
    if valid.shape != ranges.shape or valid.dtype != torch.bool:
        raise ValueError("valid must be a (B,) bool vector matching ranges")
    if active.shape != spose.shape[:1] or active.dtype != torch.bool:
        raise ValueError("active must be an (M,) bool vector matching spose")
    for t in (tex, ranges, angles, valid, active):
        if t.device != spose.device:
            raise ValueError("all inputs must be on one device")
    if spose.device.type != "cuda":
        return lf_obs_counts_plain(omap, tex, spose, ranges, angles, valid, active,
                                   skip_distance)
    m, b = spose.shape[0], ranges.shape[0]
    out = torch.empty((b,), dtype=torch.int32, device=spose.device)
    if b == 0:
        return out
    tex = tex.contiguous()
    p, r, a = _pose_beam_ptrs(spose, ranges, angles)
    valid, active = valid.contiguous(), active.contiguous()
    lib = _build.lib()
    fn = lib.lf_obs_counts_bf16_launch if tex.dtype == torch.bfloat16 \
        else lib.lf_obs_counts_f32_launch
    code = fn(tex.data_ptr(), p.data_ptr(), m, r.data_ptr(), a.data_ptr(), valid.data_ptr(),
              active.data_ptr(), b, *_geometry(omap), skip_distance, out.data_ptr(),
              _build.stream_ptr(spose.device))
    _build.check(code, "lf_obs_counts")
    lf_obs_counts.launches += 1
    return out


lf_obs_counts.launches = 0


def lf_term_sums_plain(omap, tex, spose, ranges, angles, valid, term):
    """Plain PyTorch version of the fused kernel: (M,) f32 sums over the
    beams where `valid` holds of term(distance), the combine
    `sensors.planar` applied to the (B, M) distances."""
    z = lf_distances_plain(omap, tex, spose, ranges, angles)
    return torch.where(valid[:, None], term(z), 0.0).sum(dim=0)


def lf_term_sums(omap, tex, spose, ranges, angles, valid, term):
    """Per-particle sums (M,) f32 over the valid beams of `term` (a
    `BeamTerm`) of the values of `tex` ((H, W) f32 or bf16) at the
    endpoints: one launch on CUDA tensors, nothing (B, M) in memory."""
    _check_texture(omap, tex)
    _check_poses_beams(spose, ranges, angles)
    if valid.shape != ranges.shape or valid.dtype != torch.bool:
        raise ValueError("valid must be a (B,) bool vector matching ranges")
    if spose.device.type != "cuda":
        return lf_term_sums_plain(omap, tex, spose, ranges, angles, valid, term)
    if not isinstance(term, BeamTerm):
        raise TypeError("the CUDA lf kernel computes a BeamTerm only")
    for t in (tex, ranges, angles, valid):
        if t.device != spose.device:
            raise ValueError("all inputs must be on one device")
    m, b = spose.shape[0], ranges.shape[0]
    if m == 0 or b == 0:
        return torch.zeros((m,), dtype=torch.float32, device=spose.device)
    out = torch.empty((m,), dtype=torch.float32, device=spose.device)
    tex = tex.contiguous()
    p, r, a = _pose_beam_ptrs(spose, ranges, angles)
    valid = valid.contiguous()
    lib = _build.lib()
    fn = lib.lf_term_sums_bf16_launch if tex.dtype == torch.bfloat16 \
        else lib.lf_term_sums_f32_launch
    code = fn(tex.data_ptr(), p.data_ptr(), m, r.data_ptr(),
              a.data_ptr(), valid.data_ptr(), b, *_geometry(omap),
              omap.max_distance_to_object, TERM_FORMS.index(term.form), term.z_hit,
              term.denom, term.zr, out.data_ptr(), _build.stream_ptr(spose.device))
    _build.check(code, "lf_term_sums")
    lf_term_sums.launches += 1
    return out


lf_term_sums.launches = 0


def lf_texture(omap, spose, ranges, angles):
    """The texture the JAX package's lf arm reads (`with_lf_texture`'s
    choice), after one host read of the fits flag: eager use only (the
    two textures' dtypes differ, so no graph capture takes it)."""
    return with_lf_texture(omap, spose, ranges, angles, lambda tex: tex)


def with_lf_texture(omap, spose, ranges, angles, fn):
    """fn(texture) over the texture the JAX package's lf arm reads: the
    baked bf16 one where the TPU kernel's windows fit (its contract), the
    f32 one where the JAX package takes the exact gather (maps under the
    window size, or a spread cloud), chosen by a `control.cond` on the
    windows' fits flag. fn must return the same shapes for both."""
    if omap.size_x < WIN_COLS or omap.size_y < WIN_ROWS:
        return fn(omap.distances)

    def bf16():
        if omap.distances_bf16 is None:
            raise ValueError("the map has no bf16 distance texture (with_distance_field)")
        return fn(omap.distances_bf16)

    _, _, fits = window_origins(omap, spose, ranges, angles)
    return control.cond(fits, bf16, lambda: fn(omap.distances), name="lf.window_fits")


def lf_distances_t(omap, spose, ranges, angles):
    """Full LF distance lookup in (B, M) orientation over `lf_texture`."""
    return lf_distances(omap, lf_texture(omap, spose, ranges, angles), spose, ranges, angles)
