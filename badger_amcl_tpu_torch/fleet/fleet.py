"""Fleet batching on one card: R robots' filters stepped as one batch
(counterpart of badger_amcl_tpu.fleet.fleet).

Every robot has its own state, scan, odometry and random-pose pool; the
map and the model parameters are shared. The JAX package's `vmap` is a
leading robot axis on every tensor (pf.types: a fleet MCLState), and its
per-robot PRNG keys are `FleetNoise`, drawn from one torch.Generator or
passed in. A step (`fleet_step`):

    motion update (R, M)  ->  `fleet_likelihood`: one prepass over all
    robots, ONE `fleet_corr_table` launch for all R tables, one batched
    per-particle read  ->  batched sensor update  ->  `fleet_resample`
    (composite-key KLD stop and cluster ranks over R * M), or for
    systematic resampling the batched comb `fleet_resample_systematic`
    (the JAX package vmaps `resample` there).

On the "corr" backend a step has no Python loop over robots outside its
fallback arms, and its host syncs do not grow with R: the envelope flags
of every robot in one read, the unique-key count, the cluster dilation's
fixpoint checks (pf.cluster).

`fleet_likelihood` keeps the JAX gate (fleet.py:136-155): the batched
table runs only on "corr", for a likelihood-field-family model, with the
psi texture baked for the fleet's one range_max and a map that fits;
otherwise, and when any robot leaves the lattice envelope, the robots run
`planar_likelihood` one by one (so "corr_q", as JAX "pallas_corr_q",
reads each robot's int8 table in turn, and "exact" is the per-robot CPU
reference). One deliberate divergence: a robot without a valid beam gets
p from zero taps (p = 1 for the likelihood-field model, as every
single-robot path gives); the JAX fleet kernel adds tap slot 0 (p = 1 +
psi at the robot's own cell).

Not ported here: the mesh-sharded step (`make_sharded_fleet_step`) and
`fleet_health(mesh=...)` (torch.distributed, a later slice);
`make_fleet_step` (a `jax.jit` wrapper) has no eager counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from badger_amcl_tpu_torch.ops import corr_kernel
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf import gaussian
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.pf.types import MCLState, PFParams, select_states, stack_states
from badger_amcl_tpu_torch.sensors import odom as odom_models
from badger_amcl_tpu_torch.sensors.planar import (
    CORR_MODELS, PlanarScan, coord_add, corr_combine, map_factors, planar_likelihood,
    psi_fingerprint,
)
from badger_amcl_tpu_torch.utils.numerics import host_values

FLEET_BACKENDS = ("exact", "corr", "corr_q")


@dataclasses.dataclass(frozen=True)
class FleetScan:
    """The robots' scans: ranges/angles (R, B) f32 tensors and each robot's
    range_max as a Python float."""

    ranges: torch.Tensor
    angles: torch.Tensor
    range_max: tuple

    def valid(self) -> torch.Tensor:
        """(R, B) valid beams of a fleet with one range_max (a mixed fleet
        runs robot by robot, through `robot(i).valid()`)."""
        if len(set(self.range_max)) != 1:
            raise ValueError("FleetScan.valid needs one range_max for every robot")
        return (self.ranges < self.range_max[0]) & ~torch.isnan(self.ranges)

    def robot(self, i: int) -> PlanarScan:
        return PlanarScan(ranges=self.ranges[i], angles=self.angles[i],
                          range_max=self.range_max[i])

    @staticmethod
    def tile(scan: PlanarScan, r: int) -> "FleetScan":
        """One scan repeated for R robots."""
        return FleetScan(ranges=scan.ranges.expand(r, -1).contiguous(),
                         angles=scan.angles.expand(r, -1).contiguous(),
                         range_max=(float(scan.range_max),) * r)


@dataclasses.dataclass
class FleetNoise:
    """Variates of one fleet step: odom (R, 3, M) standard normals, inject
    and pick (R, M) uniforms in [0, 1) (multinomial), start (R,) uniform
    comb starts (systematic; `draw` takes them from pick[:, 0], which the
    comb does not otherwise read)."""

    odom: torch.Tensor
    inject: torch.Tensor
    pick: torch.Tensor
    start: Optional[torch.Tensor] = None

    @staticmethod
    def draw(gen: torch.Generator, r: int, m: int, device) -> "FleetNoise":
        odom = torch.randn((r, 3, m), generator=gen, device=device)
        inject = torch.rand((r, m), generator=gen, device=device)
        pick = torch.rand((r, m), generator=gen, device=device)
        return FleetNoise(odom=odom, inject=inject, pick=pick, start=pick[:, 0])


def fleet_init(params: PFParams, means, covs, alpha_slow: float = 0.001,
               alpha_fast: float = 0.1, generator: Optional[torch.Generator] = None,
               normals: Optional[torch.Tensor] = None, device="cuda") -> MCLState:
    """Fleet state for R robots, robot i's cloud max_samples poses from
    N(means[i], covs[i]): means (R, 3), covs (R, 3, 3), the standard
    normals (R, M, 3) passed in or drawn from `generator`. Runs once, so it
    initializes robot by robot."""
    means = torch.as_tensor(means, dtype=torch.float32).to(device)
    covs = torch.as_tensor(covs, dtype=torch.float32).to(device)
    r, m = means.shape[0], params.max_samples
    if normals is None:
        if generator is None:
            raise ValueError("pass normals or a torch.Generator")
        normals = torch.randn((r, m, 3), generator=generator, device=device)
    return stack_states([
        pf_filter.init_with_poses(params, gaussian.sample_poses(normals[i], means[i], covs[i]),
                                  alpha_slow, alpha_fast)
        for i in range(r)])


def fleet_reinit_masked(states: MCLState, mask: torch.Tensor, pose_pools: torch.Tensor,
                        params: PFParams, alpha_slow: float = 0.001,
                        alpha_fast: float = 0.1) -> MCLState:
    """Global localization for a subset of the fleet (fleet.py:224-249):
    robots where mask (R,) is set restart from their row of pose_pools
    (R, M, 3), the others keep their state untouched (a masked select; the
    port has no keys to split)."""
    fresh = stack_states([pf_filter.init_with_poses(params, pose_pools[i], alpha_slow,
                                                    alpha_fast)
                          for i in range(pose_pools.shape[0])])
    return select_states(mask.to(torch.bool), fresh, states)


def fleet_health(states: MCLState) -> dict:
    """Fleet means of convergence, active particles and the top cluster
    weight, as 0-dim tensors (fleet.py:299-309, without a mesh)."""
    return {
        "converged_frac": states.converged.to(torch.float32).mean(),
        "mean_active": states.n_active.to(torch.float32).mean(),
        "mean_top_weight": states.stats.cluster_weights.max(-1).values.mean(),
    }


def _robot_by_robot(omap, params, scans, states, model, backend):
    """(p, mf), each (R, N): `planar_likelihood` for one robot after another."""
    active = states.active_mask
    out = [planar_likelihood(omap, params, scans.robot(i), states.poses[i], active[i],
                             states.n_active[i], model, converged=states.converged[i],
                             backend=backend)
           for i in range(states.poses.shape[0])]
    return torch.stack([p for p, _ in out]), torch.stack([mf for _, mf in out])


def fleet_window(omap, params, scans: FleetScan, states: MCLState):
    """The batched prepass of every robot (dedup off, as the JAX fleet) and
    the window all robots share: (prepass, valid (R, B), every robot fits,
    rows, j0), the robots' envelope flags read in one host sync."""
    spose = coord_add(params.scanner_pose, states.poses)
    valid = scans.valid()
    pre = corr_kernel.corr_prepass(omap, spose, scans.ranges, scans.angles, valid)
    fits, tight, narrow = host_values(pre["fits"].all(), pre["tight"].all(),
                                      pre["narrow"].all())
    rows, j0 = corr_kernel.window_variant(pre, bool(tight), bool(narrow))
    return pre, valid, bool(fits), rows, j0


def fleet_likelihood(omap, params, scans: FleetScan, states: MCLState,
                     model: str = "likelihood_field", backend: str = "corr"):
    """The fleet's measurement stage (fleet.py:109-221): (p (R, N), map
    factor (R, N)) for pf.filter.sensor_update. On "corr", inside the JAX
    gate, every robot's table comes from one `fleet_corr_table` launch in
    the smallest window all robots fit (tight 24 / narrow 32 / standard 64
    rows); the factors are one batched read."""
    rmax = set(scans.range_max)
    if (backend != "corr" or model not in CORR_MODELS or omap.corr_psi_pad is None
            or len(rmax) != 1
            or omap.corr_psi_key != psi_fingerprint(model, params, rmax.pop())
            or not corr_kernel.map_fits(omap)):
        return _robot_by_robot(omap, params, scans, states, model, backend)
    r, n = states.poses.shape[:2]
    pre, valid, fits, rows, j0 = fleet_window(omap, params, scans, states)
    mf = map_factors(omap, params, states.poses.reshape(-1, 3)).reshape(r, n)
    if not fits:
        return _robot_by_robot(omap, params, scans, states, model, backend)[0], mf
    n_beams = int(scans.ranges.shape[1])
    tables = corr_kernel.fleet_corr_table(omap.corr_psi_pad, pre["off"], pre["nv"],
                                          pre["t_n"], corr_kernel.table_origin(pre, j0),
                                          n_beams, rows)
    s = torch.take_along_dim(tables.reshape(r, -1), corr_kernel.particle_flat(pre, rows, j0),
                             dim=1)
    return corr_combine(model, params, s, valid.sum(1)[:, None]), mf


def fleet_step(states: MCLState, omap, scan_params, scans: FleetScan, pools: torch.Tensor,
               odom_poses, odom_deltas, absolute_motions, alphas, params: PFParams,
               odom_model=odom_models.OdomModel.DIFF,
               laser_model: str = "likelihood_field",
               resample_model=ResampleModel.MULTINOMIAL, backend: str = "corr",
               noise: Optional[FleetNoise] = None,
               generator: Optional[torch.Generator] = None) -> MCLState:
    """One full MCL step for every robot (fleet.py:44-106): odometry
    (R, 3), pools (R, M, 3); `noise` or a `generator` supplies the
    variates. Multinomial resampling takes `fleet_resample`, systematic
    the batched comb `fleet_resample_systematic` (JAX vmaps `resample`)."""
    if backend not in FLEET_BACKENDS:
        raise ValueError(f"backend must be one of {FLEET_BACKENDS}, got {backend!r}")
    if noise is None:
        if generator is None:
            raise ValueError("pass noise or a torch.Generator")
        r, m = states.weights.shape
        noise = FleetNoise.draw(generator, r, m, states.poses.device)
    states = odom_models.motion_update(states, odom_model, alphas, odom_poses, odom_deltas,
                                       noise.odom, absolute_motions)
    p, mf = fleet_likelihood(omap, scan_params, scans, states, laser_model, backend)
    states = pf_filter.sensor_update(states, p, mf)
    if resample_model == ResampleModel.SYSTEMATIC:
        return pf_filter.fleet_resample_systematic(states, params, pools, noise.start)
    return pf_filter.fleet_resample(states, params, pools, noise.inject, noise.pick)
