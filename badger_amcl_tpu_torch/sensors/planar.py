"""Planar laser likelihood-field model (counterpart of
badger_amcl_tpu.sensors.planar, the "likelihood_field" slice).

calcLikelihoodFieldModel (planar_scanner.cpp:236-323): per beam endpoint
pz = z_hit exp(-z^2 / 2 sigma^2) + z_rand / range_max, p = 1 + sum pz^3 over
valid (non-max-range, non-NaN) beams, times the recalcWeight map factor
(planar_scanner.cpp:642-682). Backends:

- "exact" (JAX "xla"): every endpoint read from the f32 distance texture;
- "lf" (JAX "pallas"): ops.lf_kernel.lf_distances_t (bf16 where the TPU
  kernel's windows fit, f32 elsewhere);
- "corr" (JAX "pallas_corr"): the stencil-correlation table on a pose
  lattice (ops.corr_kernel) with its exact fallbacks, spread clouds to
  ops.spread_kernel, everything else to "lf" — the same dispatch tree, with
  each `lax.cond` a host branch on values read in as few syncs as possible.

Scan parameters are Python floats (fixed per configuration), so texture
fingerprints need no device reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl_tpu_torch.ops import corr_kernel, lf_kernel, spread_kernel
from badger_amcl_tpu_torch.ops.spread_kernel import LFTerm
from badger_amcl_tpu_torch.utils.angles import normalize_angle
from badger_amcl_tpu_torch.utils.numerics import fdiv, host_values

BACKENDS = ("exact", "corr", "lf")


@dataclasses.dataclass(frozen=True)
class PlanarScanParams:
    """Measurement-model parameters of the likelihood-field slice
    (setModel* setters, planar_scanner.cpp:55-121)."""

    z_hit: float = 0.95
    z_rand: float = 0.05
    sigma_hit: float = 0.2
    off_map_factor: float = 1.0
    non_free_space_factor: float = 1.0
    non_free_space_radius: float = 0.0
    scanner_pose: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PlanarScan:
    """Decimated scan: ranges/angles (B,) f32 tensors in the base frame,
    range_max. Padding beams use range == range_max (skipped)."""

    ranges: torch.Tensor
    angles: torch.Tensor
    range_max: float

    def valid(self) -> torch.Tensor:
        return (self.ranges < self.range_max) & ~torch.isnan(self.ranges)


def coord_add(a, b: torch.Tensor) -> torch.Tensor:
    """Compose local pose a (3,) onto global poses b (..., 3) (coordAdd,
    planar_scanner.cpp:693-701)."""
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(bth), torch.sin(bth)
    x = bx + a[0] * c - a[1] * s
    y = by + a[0] * s + a[1] * c
    th = normalize_angle(bth + a[2])
    return torch.stack([x, y, th], dim=-1)


def _lf_term(params: PlanarScanParams, range_max: float) -> LFTerm:
    """The elementwise LF beam term pz^3 (also the corr kernel's psi). The
    constants round as the JAX package's: z_rand / range_max in f32, the
    denominator in double, cast at use."""
    zr = float(np.float32(params.z_rand) / np.float32(range_max))
    return LFTerm(z_hit=params.z_hit, denom=2.0 * params.sigma_hit * params.sigma_hit,
                  zr=zr)


def _lf_combine(params, scan, zt, valid):
    """p = 1 + sum pz^3 over valid beams, zt (B, M)."""
    pz3 = _lf_term(params, scan.range_max)(zt)
    return 1.0 + torch.where(valid[:, None], pz3, 0.0).sum(dim=0)


def _beam_endpoints_dist(omap, scan, spose, backend="exact"):
    """Endpoint distances (B, M) and the valid-beam mask; "lf" reads through
    the TPU kernel's bf16 contract, "exact" the f32 texture."""
    valid = scan.valid()
    if backend == "lf":
        zt = lf_kernel.lf_distances_t(omap, spose, scan.ranges, scan.angles)
    else:
        zt = lf_kernel.lf_distances(omap, omap.distances, spose, scan.ranges,
                                    scan.angles)
    return zt, valid


def psi_fingerprint(model: str, params: PlanarScanParams, range_max: float):
    """Everything the baked psi texture embeds; a texture serves a scan only
    when the fingerprints match exactly."""
    return (model, float(range_max), float(params.z_hit), float(params.z_rand),
            float(params.sigma_hit))


def corr_combine(model: str, s):
    """Map the corr table's psi sums to the model's p."""
    if model == "likelihood_field":
        return 1.0 + s
    raise NotImplementedError(f"the port's corr path runs likelihood_field, not {model!r}")


def _psi_pad(omap, params, range_max):
    """Padded psi texture for the corr table (planar_scanner.cpp:295-300:
    the margin reads psi(max_distance))."""
    psi = _lf_term(params, range_max)
    offmap = torch.full((), omap.max_distance_to_object, dtype=torch.float32,
                        device=omap.device)
    return corr_kernel.build_tex_pad(omap, psi(omap.distances), psi(offmap))


def bake_corr_texture(omap: OccupancyMap2D, params: PlanarScanParams,
                      range_max: float, model: str) -> OccupancyMap2D:
    """Pre-bake the padded psi texture once per (map, sensor params), as the
    reference bakes its distance LUT; a mismatched fingerprint at step time
    rebuilds it instead."""
    if (model != "likelihood_field" or omap.distances is None
            or not corr_kernel.map_fits(omap)):
        return dataclasses.replace(omap, corr_psi_pad=None, corr_psi_key=None)
    return dataclasses.replace(
        omap, corr_psi_pad=_psi_pad(omap, params, range_max),
        corr_psi_key=psi_fingerprint(model, params, range_max))


def factor_fingerprint(params: PlanarScanParams):
    """Everything the baked factor texture embeds."""
    return (float(params.non_free_space_factor), float(params.non_free_space_radius))


def _factor_texture(omap: OccupancyMap2D, params: PlanarScanParams) -> torch.Tensor:
    """Per-cell recalcWeight factor (cell state and distance fused): the
    baked copy when its fingerprint matches."""
    if omap.factor_tex is not None and omap.factor_key == factor_fingerprint(params):
        return omap.factor_tex
    nf = params.non_free_space_factor
    d = omap.distances
    interp = torch.where(
        d < params.non_free_space_radius,
        nf + fdiv(d, max(params.non_free_space_radius, 1e-30)) * (1.0 - nf), 1.0)
    return torch.where(omap.cells != int(CellState.FREE), nf, interp).to(torch.float32)


def bake_factor_texture(omap: OccupancyMap2D, params: PlanarScanParams) -> OccupancyMap2D:
    """Pre-bake the recalcWeight factor texture once per (map, params)."""
    if omap.distances is None:
        return dataclasses.replace(omap, factor_tex=None, factor_key=None)
    tex = _factor_texture(dataclasses.replace(omap, factor_tex=None, factor_key=None),
                          params)
    return dataclasses.replace(omap, factor_tex=tex, factor_key=factor_fingerprint(params))


def map_factors(omap: OccupancyMap2D, params: PlanarScanParams, poses: torch.Tensor):
    """recalcWeight (planar_scanner.cpp:642-682) per particle by a direct
    texture gather; off-map particles get off_map_factor."""
    factor_tex = _factor_texture(omap, params)
    ci, cj = omap.cells_of(poses[:, 0], poses[:, 1])
    f = factor_tex.reshape(-1)[omap.flat_index(ci, cj)]
    return torch.where(omap.in_bounds(ci, cj), f, params.off_map_factor)


def _corr_dispatch(omap, scan, spose, params, fallback_fn, fold_poses=None):
    """Stencil-correlation arm: falls back to `fallback_fn()` when the cloud,
    its yaw spread or the scan's range leaves the lattice envelope. With
    fold_poses the recalcWeight factor folds into the table read and the
    fallback must fold it too."""
    if not corr_kernel.map_fits(omap):
        return fallback_fn()
    valid = scan.valid()
    n_beams = int(scan.ranges.shape[0])
    # dedup pays from >= 360 beams (the JAX package's measured gate)
    pre = corr_kernel.corr_prepass(omap, spose, scan.ranges, scan.angles, valid,
                                   dedup=n_beams >= 360)
    preds = [pre["fits"], pre["tight"], pre["narrow"]]
    if fold_poses is not None:
        ci_f, cj_f = omap.cells_of(fold_poses[:, 0], fold_poses[:, 1])
        preds.append(omap.in_bounds(ci_f, cj_f).all())
    flags = host_values(*preds)
    if not flags[0]:
        return fallback_fn()
    fold = None
    if fold_poses is not None:
        fold = corr_kernel.Fold(
            combine=lambda s: corr_combine("likelihood_field", s),
            factor_tex=_factor_texture(omap, params), all_valid=bool(flags[3]),
            fallback_mf=lambda: map_factors(omap, params, fold_poses))
    want = psi_fingerprint("likelihood_field", params, scan.range_max)
    if omap.corr_psi_pad is not None and omap.corr_psi_key == want:
        tex_pad = omap.corr_psi_pad
    else:
        tex_pad = _psi_pad(omap, params, scan.range_max)
    rows, j0 = corr_kernel.window_variant(pre, bool(flags[1]), bool(flags[2]))
    s = corr_kernel.corr_values(tex_pad, pre, n_beams, rows, j0, fold)
    return s if fold is not None else corr_combine("likelihood_field", s)


# the JAX package's small-cloud gate: below it the exact gather beats its
# tiled spread kernel (planar.py:376-379)
SPREAD_MIN_PARTICLES = 8192
SPREAD_MIN_EVALS = 4_000_000


def _spread_dispatch(omap, scan, spose, term, finalize_fn, fallback_fn):
    """Spread-cloud arm: per-particle term sums from the quantized texture,
    or `fallback_fn()` where the JAX package falls back statically."""
    if omap.distances is None or not spread_kernel.tex_fits(omap):
        return fallback_fn()
    m, b = int(spose.shape[0]), int(scan.ranges.shape[0])
    if m < SPREAD_MIN_PARTICLES and m * b < SPREAD_MIN_EVALS:
        return fallback_fn()
    s = spread_kernel.spread_term_sums(omap, spose, scan.ranges, scan.angles,
                                       scan.valid(), term)
    return finalize_fn(s)


def _fold_mf(omap, params, fold_poses):
    """Fallback arms of a folding corr dispatch multiply the factors in."""
    if fold_poses is None:
        return lambda p: p
    return lambda p: p * map_factors(omap, params, fold_poses)


def _lf_model(omap, params, scan, spose, backend="exact", fold_poses=None):
    """calcLikelihoodFieldModel over the backend's dispatch tree."""
    if backend == "corr":
        mulf = _fold_mf(omap, params, fold_poses)
        return _corr_dispatch(
            omap, scan, spose, params,
            lambda: mulf(_spread_dispatch(
                omap, scan, spose, _lf_term(params, scan.range_max),
                lambda s: 1.0 + s,
                lambda: _lf_model(omap, params, scan, spose, "lf"))),
            fold_poses=fold_poses)
    zt, valid = _beam_endpoints_dist(omap, scan, spose, backend)
    return _lf_combine(params, scan, zt, valid)


def planar_likelihood(omap, params, scan, poses, active, n_active,
                      model: str = "likelihood_field", converged=False,
                      do_beamskip: bool = False, backend: str = "exact",
                      fold_factors: bool = False):
    """applyModelToSampleSet (planar_scanner.cpp:141-164): returns
    (p_model (M,), map_factor (M,) or None) for pf.filter.sensor_update.
    With fold_factors on the corr backend the factor is folded into p and
    map_factor is None (exactly equivalent in sensor_update)."""
    if model != "likelihood_field" or do_beamskip:
        raise NotImplementedError(
            f"the port runs the likelihood_field model without beam skipping, "
            f"not {model!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    fold = fold_factors and backend == "corr"
    fold_poses = poses if fold else None
    spose = coord_add(params.scanner_pose, poses)
    p = _lf_model(omap, params, scan, spose, backend, fold_poses=fold_poses)
    if fold:
        return p, None
    return p, map_factors(omap, params, poses)
