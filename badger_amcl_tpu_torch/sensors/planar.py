"""Planar laser measurement models (counterpart of
badger_amcl_tpu.sensors.planar).

All four models of the reference's PlanarScanner (planar_scanner.cpp):
- "beam" (calcBeamModel, :168-234): a per-beam map raycast and the 4-part
  hit/short/max/rand mixture, p = 1 + sum pz^3 over all beams;
- "likelihood_field" (calcLikelihoodFieldModel, :236-323): pz = z_hit
  exp(-z^2 / 2 sigma^2) + z_rand / range_max at each endpoint, p = 1 +
  sum pz^3 over valid (non-max-range, non-NaN) beams;
- "likelihood_field_gompertz" (:552-640): the mean pz (z_rand added raw)
  through the Gompertz squash;
- "likelihood_field_prob" (:325-533): p = exp(sum log pz), with beam
  skipping and, for the log-space pipeline, log p itself;
plus the recalcWeight map factor (:642-682) and coordAdd (:693-701).

Backends:
- "exact" (JAX "xla"): the LF models read every endpoint from the f32
  distance texture; the beam model raycasts (sensors.raycast);
- "lf" (JAX "pallas"): the LF models read through ops.lf_kernel (bf16
  where the TPU kernel's windows fit); the beam model raycasts. On both
  arms the term sums are fused (`lf_kernel.lf_term_sums`); beam skipping
  counts each beam's agreeing particles (`lf_kernel.lf_obs_counts`), then
  takes the fused sums over the beams it keeps: nothing (B, M);
- "corr" (JAX "pallas_corr"): the JAX dispatch tree — for the LF models
  the correlation table (ops.corr_kernel) with the model's psi texture,
  spread clouds to ops.spread_kernel, everything else to "lf"; for the
  beam model the lattice kernel (ops.beam_kernel) where the cloud fits,
  the spread kernel (ops.beam_spread_kernel) where the transposed range
  image is baked, the raycast otherwise. Each `lax.cond` is a
  `utils.control.cond`: in an eager step a host branch on values read in
  as few syncs as possible (`control.read`), in a compiled step a
  conditional node of its graph;
- "corr_q" (JAX "pallas_corr_q"): the "corr" tree, except that the
  likelihood-field and Gompertz models read their table from the int8
  quantized psi texture (ops.corr_kernel.corr_table_q) where it is baked
  with a matching fingerprint (planar.py:321-332); the prob model is never
  quantized.

Scan parameters are Python floats (fixed per configuration), so texture
fingerprints need no device reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
from badger_amcl_tpu_torch.ops import (
    beam_kernel, beam_spread_kernel, corr_kernel, lf_kernel, spread_kernel,
)
from badger_amcl_tpu_torch.ops.spread_kernel import BeamTerm
from badger_amcl_tpu_torch.sensors.raycast import calc_range
from badger_amcl_tpu_torch.utils.angles import normalize_angle
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.numerics import fdiv

BACKENDS = ("exact", "corr", "corr_q", "lf")
MODELS = ("beam", "likelihood_field", "likelihood_field_prob",
          "likelihood_field_gompertz")
CORR_MODELS = ("likelihood_field", "likelihood_field_prob", "likelihood_field_gompertz")


@dataclasses.dataclass(frozen=True)
class PlanarScanParams:
    """Measurement-model parameters (setModel* setters,
    planar_scanner.cpp:55-121), as Python floats."""

    z_hit: float = 0.95
    z_short: float = 0.1
    z_max: float = 0.05
    z_rand: float = 0.05
    sigma_hit: float = 0.2
    lambda_short: float = 0.1
    # Gompertz squashing (setModelLikelihoodFieldGompertz, :94-113)
    gompertz_a: float = 1.0
    gompertz_b: float = 1.0
    gompertz_c: float = 1.0
    input_shift: float = 0.0
    input_scale: float = 1.0
    output_shift: float = 0.0
    # map factors (setMapFactors, :115-121)
    off_map_factor: float = 1.0
    non_free_space_factor: float = 1.0
    non_free_space_radius: float = 0.0
    # beam skipping (setModelLikelihoodFieldProb, :77-92)
    beam_skip_distance: float = 0.5
    beam_skip_threshold: float = 0.3
    beam_skip_error_threshold: float = 0.9
    # scanner mount pose in the base frame (setPlanarScannerPose, :535-538)
    scanner_pose: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PlanarScan:
    """Decimated scan: ranges/angles (B,) f32 tensors in the base frame,
    range_max. Padding beams use range == range_max (skipped by the LF
    models, max-range readings to the beam model)."""

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


def apply_gompertz(params, p: torch.Tensor) -> torch.Tensor:
    """applyGompertz (planar_scanner.cpp:540-550; point_cloud_scanner.cpp
    :250-260 is the same function)."""
    p = p * params.input_scale + params.input_shift
    p = params.gompertz_a * torch.exp(-params.gompertz_b * torch.exp(-params.gompertz_c * p))
    return p + params.output_shift


def model_term(model: str, params: PlanarScanParams, range_max: float) -> BeamTerm:
    """The elementwise beam term of an LF-family model, which is also its
    corr psi: pz^3, log pz (z_rand / range_max) or the Gompertz pz (z_rand
    raw, planar_scanner.cpp:597). The constants round as the JAX
    package's: z_rand / range_max in f32, the denominator in double, cast
    at use."""
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    if model == "likelihood_field_gompertz":
        return BeamTerm(z_hit=params.z_hit, denom=denom, zr=params.z_rand, form="pz")
    zr = float(np.float32(params.z_rand) / np.float32(range_max))
    form = {"likelihood_field": "cube", "likelihood_field_prob": "log"}[model]
    return BeamTerm(z_hit=params.z_hit, denom=denom, zr=zr, form=form)


def corr_combine(model: str, params: PlanarScanParams, s, n_valid, log_p: bool = False):
    """Map per-particle term sums (corr table or spread sums) to the
    model's p; n_valid is the valid-beam count (a device scalar)."""
    if model == "likelihood_field":
        return 1.0 + s
    if model == "likelihood_field_prob":
        return s if log_p else torch.exp(s)
    if model == "likelihood_field_gompertz":
        p = apply_gompertz(params, s / n_valid.clamp(min=1))
        return torch.where(n_valid > 0, p, 1.0)
    raise ValueError(f"no corr combine for model {model!r}")


def psi_fingerprint(model: str, params: PlanarScanParams, range_max: float):
    """Everything the baked psi texture embeds; a texture serves a scan only
    when the fingerprints match exactly."""
    return (model, float(range_max), float(params.z_hit), float(params.z_rand),
            float(params.sigma_hit))


def _psi_texture(omap, params, range_max, model):
    """(psi per map cell, psi off the map) for the corr tables
    (planar_scanner.cpp:295-300: the margin reads psi(max_distance))."""
    psi = model_term(model, params, range_max)
    offmap = torch.full((), omap.max_distance_to_object, dtype=torch.float32,
                        device=omap.device)
    return psi(omap.distances), psi(offmap)


def bake_corr_texture(omap: OccupancyMap2D, params: PlanarScanParams,
                      range_max: float, model: str) -> OccupancyMap2D:
    """Pre-bake the padded psi texture once per (map, sensor params, model),
    as the reference bakes its distance LUT; a mismatched fingerprint at
    step time rebuilds it instead. Beside it the int8 quantized twin for
    the corr_q backend (planar.py:205-213), except for the prob model,
    whose exp(sum log pz) would amplify the quantization."""
    if (model not in CORR_MODELS or omap.distances is None
            or not corr_kernel.map_fits(omap)):
        return dataclasses.replace(omap, corr_psi_pad=None, corr_psi_key=None,
                                   corr_psi_pad_q=None, corr_psi_q=None)
    tex_psi, offmap = _psi_texture(omap, params, range_max, model)
    pad_q, qscale = None, None
    if model != "likelihood_field_prob" and corr_kernel.map_fits_q(omap):
        pad_q, qscale = corr_kernel.build_tex_pad_q(omap, tex_psi, offmap)
    return dataclasses.replace(
        omap, corr_psi_pad=corr_kernel.build_tex_pad(omap, tex_psi, offmap),
        corr_psi_key=psi_fingerprint(model, params, range_max),
        corr_psi_pad_q=pad_q, corr_psi_q=qscale)


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


def _corr_flags(omap, scan, spose, fold_poses=None):
    """The corr arm's prepass (dedup from 360 beams, the JAX package's
    measured gate) and its predicates, read in one host sync (device flags
    in a capture, `control.read`): (pre, valid, fits, tight, narrow,
    all_valid); all_valid (every fold pose on the map) is None without
    fold_poses."""
    valid = scan.valid()
    pre = corr_kernel.corr_prepass(omap, spose, scan.ranges, scan.angles, valid,
                                   dedup=int(scan.ranges.shape[0]) >= 360)
    preds = [pre["fits"], pre["tight"], pre["narrow"]]
    if fold_poses is not None:
        ci_f, cj_f = omap.cells_of(fold_poses[:, 0], fold_poses[:, 1])
        preds.append(omap.in_bounds(ci_f, cj_f).all())
    fits, tight, narrow, *all_valid = control.read(*preds)
    return pre, valid, fits, tight, narrow, all_valid[0] if all_valid else None


def _baked(omap, params, scan, model) -> bool:
    """Whether the map's baked psi texture serves this scan and model."""
    return (omap.corr_psi_pad is not None
            and omap.corr_psi_key == psi_fingerprint(model, params, scan.range_max))


def _tex_pad(omap, params, scan, model):
    """The psi texture of this scan: the baked one where it serves, else
    built now."""
    if _baked(omap, params, scan, model):
        return omap.corr_psi_pad
    return corr_kernel.build_tex_pad(omap, *_psi_texture(omap, params, scan.range_max, model))


def _corr_dispatch(omap, scan, spose, params, model, combine, fallback_fn,
                   fold_poses=None, quantized=False):
    """Stencil-correlation arm: falls back to `fallback_fn()` when the cloud,
    its yaw spread or the scan's range leaves the lattice envelope.
    `combine(s, n_valid)` maps psi sums to p. With fold_poses the
    recalcWeight factor folds into the table read and the fallback must
    fold it too. `quantized` reads the int8 table where its texture is
    baked for this scan (the f32 table otherwise)."""
    if not corr_kernel.map_fits(omap):
        return fallback_fn()
    pre, valid, fits, tight, narrow, all_valid = _corr_flags(omap, scan, spose, fold_poses)
    n_beams = int(scan.ranges.shape[0])
    n_valid = valid.sum()
    fold = None
    if fold_poses is not None:
        fold = corr_kernel.Fold(
            combine=lambda s: combine(s, n_valid),
            factor_tex=_factor_texture(omap, params), all_valid=all_valid,
            fallback_mf=lambda: map_factors(omap, params, fold_poses))

    def finish(s):
        return s if fold is not None else combine(s, n_valid)

    if quantized and _baked(omap, params, scan, model) and omap.corr_psi_pad_q is not None:
        def table():
            return finish(corr_kernel.corr_values_q(omap.corr_psi_pad_q, omap.corr_psi_q,
                                                    pre, n_beams, narrow, fold))
    else:
        def table():
            tex_pad = _tex_pad(omap, params, scan, model)
            return corr_kernel.window_cond(pre, tight, narrow, lambda rows, j0: finish(
                corr_kernel.corr_values(tex_pad, pre, n_beams, rows, j0, fold)))
    return control.cond(fits, table, fallback_fn, name="corr.fits")


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


def _lf_model(omap, params, scan, spose, model, backend="exact", fold_poses=None,
              log_p=False, quantized=False):
    """calcLikelihoodFieldModel, its Gompertz twin and the prob model
    without beam skipping, over the backend's dispatch tree: the sum of the
    model's term over valid beams, then its combine."""
    term = model_term(model, params, scan.range_max)

    def combine(s, n_valid):
        return corr_combine(model, params, s, n_valid, log_p)

    if backend == "corr":
        mulf = _fold_mf(omap, params, fold_poses)
        n_valid = scan.valid().sum()
        return _corr_dispatch(
            omap, scan, spose, params, model, combine,
            lambda: mulf(_spread_dispatch(
                omap, scan, spose, term, lambda s: combine(s, n_valid),
                lambda: _lf_model(omap, params, scan, spose, model, "lf", log_p=log_p))),
            fold_poses=fold_poses, quantized=quantized)
    valid = scan.valid()

    def sums(tex):
        return lf_kernel.lf_term_sums(omap, tex, spose, scan.ranges, scan.angles, valid, term)

    s = (lf_kernel.with_lf_texture(omap, spose, scan.ranges, scan.angles, sums)
         if backend == "lf" else sums(omap.distances))
    return combine(s, valid.sum())


def _lf_prob_beamskip(omap, params, scan, spose, active, n_active, converged, backend):
    """calcLikelihoodFieldModelProb with beam skipping (planar_scanner.cpp
    :361-530), as log p: beams that fewer than beam_skip_threshold of the
    active particles see within beam_skip_distance of the map are skipped
    for everyone once the filter has converged; if too many are skipped
    (>= B * error_threshold), every beam counts, and invalid beams, whose
    temp pz is 0, give log 0 = -inf (planar.py:550-570). Two passes over
    the endpoints, nothing (B, M): the per-beam counts, then the log pz
    sums over the beams kept; the skip rule runs on (B,) device vectors."""
    valid = scan.valid()
    if not isinstance(converged, torch.Tensor):  # filled on the device: no host copy
        converged = torch.full((), bool(converged), device=valid.device)
    term = model_term("likelihood_field_prob", params, scan.range_max)

    def skip(tex):
        obs_count = lf_kernel.lf_obs_counts(omap, tex, spose, scan.ranges, scan.angles, valid,
                                            active, params.beam_skip_distance)
        obs_mask = obs_count.to(torch.float32) / n_active.to(torch.float32).clamp(min=1.0) > \
            params.beam_skip_threshold
        skipped = (~obs_mask).sum()
        error = skipped >= scan.ranges.shape[0] * params.beam_skip_error_threshold
        use_beam = error | obs_mask
        s = lf_kernel.lf_term_sums(omap, tex, spose, scan.ranges, scan.angles,
                                   valid & (use_beam | ~converged), term)
        # an invalid beam in use adds log 0 for every particle
        return torch.where(converged & (use_beam & ~valid).any(), float("-inf"), s)

    return (lf_kernel.with_lf_texture(omap, spose, scan.ranges, scan.angles, skip)
            if backend == "lf" else skip(omap.distances))


def _beam_exact(omap, params, scan, spose):
    """calcBeamModel over the exact Bresenham raycast (planar.py:620-636):
    p = 1 + sum over all beams of pz^3, (M,)."""
    map_range = calc_range(omap, spose[:, 0:1], spose[:, 1:2],
                           spose[:, 2:3] + scan.angles[None, :], scan.range_max)
    mix = beam_kernel.BeamMix.of(params, scan.range_max, omap.resolution)
    pz3 = beam_kernel.beam_pz3(mix, scan.ranges[None, :], map_range, divide=True)
    return 1.0 + pz3.sum(dim=1)


def _beam_route(omap, scan, spose, backend):
    """The beam dispatch's static part (planar.py:582-619): (the lattice
    kernel's prepass, whose fits flag picks the table arm, or None off the
    "corr" backend or without a range image in the kernel's gate; the slow
    arm: "spread" where the transposed range image is baked and its value
    table covers range_max, "exact", the raycast, otherwise)."""
    if backend != "corr" or not beam_kernel.ri_fits(omap):
        return None, "exact"
    slow = ("spread" if omap.range_rows is not None
            and beam_spread_kernel.fits(omap, scan.range_max) else "exact")
    return beam_kernel.beam_prepass(omap, spose, scan.range_max), slow


def beam_arm(omap, scan, spose, backend="corr") -> str:
    """Which arm of the beam dispatch a cloud takes: "table", "spread" or
    "exact" (an eager diagnostic: one host read of the fits flag)."""
    pre, slow = _beam_route(omap, scan, spose, backend)
    if pre is None:
        return slow
    (fits,) = control.read(pre["fits"])
    return "table" if fits else slow


def _beam_model(omap, params, scan, spose, backend="exact"):
    """calcBeamModel over the JAX dispatch tree (planar.py:573-636), routed
    by `_beam_route`: a `control.cond` on the prepass's fits flag between
    the lattice table (its window variant a `window_cond`) and the slow
    arm; the raycast where there is no prepass. The three flags are read in
    one host sync in an eager step (`control.read`)."""
    pre, slow = _beam_route(omap, scan, spose, backend)
    if pre is None:
        return _beam_exact(omap, params, scan, spose)
    fits, tight, narrow = control.read(pre["fits"], pre["tight"], pre["narrow"])

    def table():
        return corr_kernel.window_cond(
            pre, tight, narrow,
            lambda rows, j0: beam_kernel.beam_corr_values(omap, params, scan, pre, rows, j0),
            name="beam.window")

    def slow_arm():
        if slow == "spread":
            return beam_spread_kernel.beam_spread_values(omap, params, scan, spose)
        return _beam_exact(omap, params, scan, spose)

    return control.cond(fits, table, slow_arm, name="beam.fits")


def planar_likelihood(omap, params, scan, poses, active, n_active,
                      model: str = "likelihood_field", converged=False,
                      do_beamskip: bool = False, backend: str = "exact",
                      fold_factors: bool = False, prob_log_space: bool = False):
    """applyModelToSampleSet (planar_scanner.cpp:141-164): returns
    (p_model (M,), map_factor (M,) or None) for pf.filter.sensor_update.
    With fold_factors on the corr backend the factor is folded into p and
    map_factor is None (exactly equivalent in sensor_update), except for
    the beam model and the prob model with beam skipping or in log space
    (planar.py:780-788). prob_log_space (likelihood_field_prob) returns
    log p for pf.filter.sensor_update_log."""
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    prob = model == "likelihood_field_prob"
    # corr_q is the corr tree; only its LF and Gompertz tables are int8
    quantized = backend == "corr_q" and not prob
    if backend == "corr_q":
        backend = "corr"
    fold = fold_factors and backend == "corr" and (
        model in ("likelihood_field", "likelihood_field_gompertz")
        or (prob and not do_beamskip and not prob_log_space))
    fold_poses = poses if fold else None
    spose = coord_add(params.scanner_pose, poses)
    if model == "beam":
        p = _beam_model(omap, params, scan, spose, backend)
    elif prob and do_beamskip:
        # beam skipping needs every endpoint: the corr backend takes "lf"
        log_p = _lf_prob_beamskip(omap, params, scan, spose, active, n_active, converged,
                                  "lf" if backend == "corr" else backend)
        p = log_p if prob_log_space else torch.exp(log_p)
    else:
        p = _lf_model(omap, params, scan, spose, model, backend, fold_poses=fold_poses,
                      log_p=prob and prob_log_space, quantized=quantized)
    if fold:
        return p, None
    return p, map_factors(omap, params, poses)


# the models whose table-side combine the cell-space resampling contract
# supports: the factor-folding models, beam skipping aside (planar.py:813)
CELL_MODELS = ("likelihood_field", "likelihood_field_gompertz", "likelihood_field_prob")


def planar_likelihood_cells(omap, params, scan, poses, model: str, backend: str = "corr"):
    """The cell-space twin of `planar_likelihood` for the cell resampling
    contract (planar.py:817-852, pf.filter.sensor_resample_cells): (tbl
    (T_FLAT_CELLS,) f32, key (M,) int64, ok): the folded p * recalcWeight
    factor of every lattice cell and each particle's cell in it
    (`corr_kernel.corr_cells`, kernel #1/#2), with no per-particle take.
    The combines are JAX's: 1 + s, Gompertz of the mean term (1 without a
    valid beam) and exp(s) for prob (the exp form, not the log-space
    pipeline). ok is whether the cloud fits the lattice envelope and every
    particle is on the map (planar.py:260-265,290-315): a bool read in the
    prepass's one host sync, or a device flag while a graph is captured.
    As in JAX, the table is built before ok is known, whatever ok turns
    out to be (the kernel and the take are memory-safe on any cloud); the
    caller runs the pick-level step where ok is False. A map that misses
    the corr gate returns (None, None, False): no table at all."""
    if backend != "corr":
        raise ValueError(f"the cell contract needs the corr backend, got {backend!r}")
    if model not in CELL_MODELS:
        raise ValueError(f"the cell contract does not support model {model!r}")
    if not corr_kernel.map_fits(omap):
        return None, None, False
    spose = coord_add(params.scanner_pose, poses)
    pre, valid, fits, tight, narrow, all_valid = _corr_flags(omap, scan, spose, poses)
    n_valid = valid.sum()
    fold = corr_kernel.Fold(combine=lambda s: corr_combine(model, params, s, n_valid),
                            factor_tex=_factor_texture(omap, params), all_valid=True,
                            fallback_mf=None)
    tex_pad = _tex_pad(omap, params, scan, model)
    tbl, key = corr_kernel.window_cond(pre, tight, narrow, lambda rows, j0: corr_kernel.corr_cells(
        tex_pad, pre, int(scan.ranges.shape[0]), rows, j0, fold))
    return tbl, key, fits & all_valid
