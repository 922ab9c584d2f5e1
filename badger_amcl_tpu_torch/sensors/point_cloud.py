"""3D point-cloud measurement models (counterpart of
badger_amcl_tpu.sensors.point_cloud).

Both models of the reference's PointCloudScanner
(point_cloud_scanner.cpp): likelihood_field (:132-167), p = 1 + sum pz^3
over every point with pz = z_hit exp(-z^2 / 2 sigma^2) + z_rand / max_dist,
and likelihood_field_gompertz (:169-203), the mean pz (z_rand added raw)
through the Gompertz squash; plus the off-map factor (recalcWeight,
:205-229). The scanner extrinsic is folded into the cloud before the call
(points_base), so a particle's transform is a z-rotation plus a planar
translation.

Backends:
- "exact" (JAX "xla"): every point read through `OctoMap3D.distance_at`
  at world_to_map of the transformed cloud;
- "corr" and "lf" (JAX "pallas" and "pallas_corr", which the JAX package
  treats alike): the kernel cascade — ops.pc_kernel's fused term sums
  where its windows fit (converged and tracking clouds), else
  ops.pc_spread_kernel where its texture gate holds (spread clouds), else
  the exact gather. The windowed predicate (the CUDA window prepass, then
  (B,) vectors) is a `utils.control.cond` named "pc.fits": one host sync
  in an eager call, a conditional node of a compiled one (the nodes'
  `_sensor_update_jit`, `_score_poses_jit`); the texture gates are
  static properties of the map and stay Python branches.

Parameters are Python floats (fixed per configuration).
"""

from __future__ import annotations

import dataclasses

import torch

from badger_amcl_tpu_torch.ops import pc_kernel, pc_spread_kernel
from badger_amcl_tpu_torch.ops.pc_kernel import PCTerm
from badger_amcl_tpu_torch.sensors.planar import apply_gompertz
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.numerics import fdiv

BACKENDS = ("exact", "corr", "lf")


@dataclasses.dataclass(frozen=True)
class PointCloudParams:
    """setPointCloudModel / setPointCloudModelGompertz / setMapFactors
    (point_cloud_scanner.cpp:53-83)."""

    z_hit: float = 0.95
    z_rand: float = 0.05
    sigma_hit: float = 0.2
    gompertz_a: float = 1.0
    gompertz_b: float = 1.0
    gompertz_c: float = 1.0
    input_shift: float = 0.0
    input_scale: float = 1.0
    output_shift: float = 0.0
    off_map_factor: float = 1.0
    non_free_space_factor: float = 1.0
    non_free_space_radius: float = 0.0


def transform_cloud_to_map(points_base: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """getMapCloud's math (point_cloud_scanner.cpp:231-248), batched:
    (B, 3) points in the footprint frame, (N, 3) poses -> (N, B, 3)."""
    c = torch.cos(poses[:, 2])[:, None]
    s = torch.sin(poses[:, 2])[:, None]
    px, py, pz = points_base[:, 0][None], points_base[:, 1][None], points_base[:, 2][None]
    mx = poses[:, 0][:, None] + c * px - s * py
    my = poses[:, 1][:, None] + s * px + c * py
    return torch.stack([mx, my, pz.expand_as(mx)], dim=-1)


def _model_term_finalize(omap, params: PointCloudParams, model: str, n_points: int):
    """(term elementwise over distances, finalize over per-particle term
    sums, combine over a dense (B, N) distance matrix) of a model."""
    denom = 2.0 * params.sigma_hit * params.sigma_hit
    if model == "likelihood_field":
        term = PCTerm(z_hit=params.z_hit, denom=denom,
                      zr=params.z_rand / omap.max_distance_to_object, cube=True)

        def finalize(s):
            return 1.0 + s
    elif model == "likelihood_field_gompertz":
        term = PCTerm(z_hit=params.z_hit, denom=denom, zr=params.z_rand, cube=False)

        def finalize(s):
            # the mean over the whole cloud, out-of-band points included
            return apply_gompertz(params, fdiv(s, float(n_points)))
    else:
        raise ValueError(f"unknown point cloud model {model!r}")

    def combine(zt):
        return finalize(term(zt).sum(dim=0))

    return term, finalize, combine


def _exact_distances(omap, points_base, poses) -> torch.Tensor:
    """(B, N) distances through world_to_map + distance_at."""
    cloud = transform_cloud_to_map(points_base, poses)
    return omap.distance_at(omap.world_to_map(cloud)).T


def point_cloud_likelihood(omap, params: PointCloudParams, points_base: torch.Tensor,
                           poses: torch.Tensor, model: str = "likelihood_field",
                           backend: str = "exact"):
    """applyModelToSampleSet (point_cloud_scanner.cpp:106-129): returns
    (p_model (N,), map_factor (N,)) for pf.filter.sensor_update."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if omap.tex_zyx is None:
        raise ValueError("the map has no distance field (with_distance_field)")
    term, finalize, combine = _model_term_finalize(omap, params, model,
                                                   points_base.shape[0])
    def exact():
        return combine(_exact_distances(omap, points_base, poses))

    def spread():
        if pc_spread_kernel.tex_fits(omap):
            return finalize(pc_spread_kernel.pc_spread_term_sums(omap, poses, points_base,
                                                                 term))
        return exact()

    def windowed():
        return finalize(pc_kernel.pc_term_sums(omap, points_base, poses, term))

    if backend == "exact":
        p = exact()
    elif pc_kernel.tex_fits(omap):
        p = control.cond(pc_kernel.window_origins(omap, points_base, poses)[3], windowed,
                         spread, name="pc.fits")
    else:
        p = spread()
    return p, map_factors(omap, params, poses)


def map_factors(omap, params: PointCloudParams, poses: torch.Tensor) -> torch.Tensor:
    """recalcWeight (point_cloud_scanner.cpp:205-229): only the off-map
    penalty applies in 3D, judged on the particle's 2D cell."""
    cells = omap.world_to_map(poses[:, :2])
    valid = omap.is_pose_valid(cells[..., 0], cells[..., 1])
    return torch.where(valid, 1.0, params.off_map_factor).to(torch.float32)
