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
robot-by-robot arm, and an eager step's host syncs do not grow with R: the
envelope flags of every robot in one read, the unique-key count
(pf.cluster). Each such branch is a `utils.control.cond`: "fleet.fits"
(the batched table or the robots one by one), "fleet.window.*" (the
window), "cluster.fleet_u" (the compacted or the batched grid ranks).
`make_fleet_step` compiles the step (JAX jits it): on the card one CUDA
graph per static key, every cond a conditional node, no host read inside
a replay (`utils.graph.graph_jit`).

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

Several cards (fleet.py:255-329, over torch.distributed in place of a
`Mesh`): `make_sharded_fleet_step` splits the robots over a process
group's ranks in contiguous blocks of R / world, in rank order, as
`P("fleet")` splits them; the map and the model parameters are
replicated. Each rank steps its own robots with `fleet_step`, with no
collective on the step's path (robots are independent);
`fleet_health(states, group)` is the one collective, a single
`all_reduce`. `shard_robots` and `gather_robots` place a whole fleet's
tensors on the ranks and read them back whole (the counterparts of a
`NamedSharding` placement and a sharded array read whole).
`init_fleet_group` starts the process group: NCCL for a CUDA fleet, gloo
for a CPU one. Each rank's step is `make_fleet_step`'s compiled one, one
graph entry per rank's card; `fleet_health` stays outside every graph (its
`all_reduce` is a collective, and without a group it is three means).

The per-rank noise: `FleetNoise.draw` draws one stream for the robots it
is given, so a rank that draws its own (R / world, ...) noise, or steps
from its own generator, gets other variates than the one-process run
over all R robots. That is correct, but a run that must equal the
one-process step slices one global draw per rank (`shard_robots`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from badger_amcl_tpu_torch.ops import corr_kernel
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf import gaussian
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.pf.types import (
    MCLState, PFParams, map_tensors, select_states, stack_states,
)
from badger_amcl_tpu_torch.sensors import odom as odom_models
from badger_amcl_tpu_torch.sensors.planar import (
    CORR_MODELS, PlanarScan, coord_add, corr_combine, map_factors, planar_likelihood,
    psi_fingerprint,
)
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.graph import device_tensor, graph_jit

FLEET_BACKENDS = ("exact", "corr", "corr_q")


def _row(t: torch.Tensor, i):
    """Row i of t: i a Python int, or a 0-dim int64 device tensor (a
    captured loop's counter, read on the device)."""
    return t[i] if isinstance(i, int) else t.index_select(0, i.reshape(1))[0]


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

    def robot(self, i) -> PlanarScan:
        """Robot i's scan: i a Python int, or a 0-dim int64 device tensor
        (a captured loop's counter) where every robot has one range_max."""
        if isinstance(i, int):
            rmax = self.range_max[i]
        elif len(set(self.range_max)) == 1:
            rmax = self.range_max[0]
        else:
            raise ValueError("a device index needs one range_max for every robot")
        return PlanarScan(ranges=_row(self.ranges, i), angles=_row(self.angles, i),
                          range_max=rmax)

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


def fleet_health(states: MCLState, group=None) -> dict:
    """Fleet means of convergence, active particles and the top cluster
    weight, as 0-dim tensors (fleet.py:299-329). Without a group, over the
    robots of `states`. With a process group (the JAX mesh), over every
    rank's robots: each rank forms (sum converged, sum n_active, sum of
    top cluster weights, robot count) and does one `all_reduce`, on the
    CPU for gloo (four floats) and on the states' device otherwise."""
    top = states.stats.cluster_weights.max(-1).values
    if group is None:
        return {
            "converged_frac": states.converged.to(torch.float32).mean(),
            "mean_active": states.n_active.to(torch.float32).mean(),
            "mean_top_weight": top.mean(),
        }
    n = torch.full((), states.poses.shape[0], dtype=torch.float32, device=top.device)
    sums = torch.stack([states.converged.to(torch.float32).sum(),
                        states.n_active.to(torch.float32).sum(), top.sum(), n])
    sums = sums.to(_comm_device(group, top.device))
    dist.all_reduce(sums, group=group)
    return {"converged_frac": sums[0] / sums[3], "mean_active": sums[1] / sums[3],
            "mean_top_weight": sums[2] / sums[3]}


def _robot_by_robot(omap, params, scans, states, model, backend):
    """(p, mf), each (R, N): `planar_likelihood` for one robot after
    another, each robot through its own dispatch (JAX's `lax.map`). With
    one range_max for every robot the robots are a `control.fori_loop`,
    so a compiled step captures the dispatch once, not once a robot; a
    mixed fleet's robots each key their own (the range_max is static)."""
    r, n = states.poses.shape[:2]
    dev = states.poses.device
    uniform = len(set(scans.range_max)) == 1

    def robot(i, carry):
        p, mf = carry
        p_i, mf_i = planar_likelihood(omap, params, scans.robot(i), _row(states.poses, i),
                                      _row(states.active_mask, i), _row(states.n_active, i),
                                      model, converged=_row(states.converged, i),
                                      backend=backend)
        if isinstance(i, int):
            p[i], mf[i] = p_i, mf_i
        else:
            p.index_copy_(0, i.reshape(1), p_i[None])
            mf.index_copy_(0, i.reshape(1), mf_i[None])
        return p, mf

    carry = (torch.empty((r, n), device=dev), torch.empty((r, n), device=dev))
    if not uniform:
        for i in range(r):
            carry = robot(i, carry)
        return carry
    return control.fori_loop(r, robot, carry, name="fleet.robot")


def fleet_window(omap, params, scans: FleetScan, states: MCLState):
    """The batched prepass of every robot (dedup off, as the JAX fleet) and
    the flags of the window all robots share: (prepass, valid (R, B),
    every robot fits, every robot fits the tight window, every robot fits
    the narrow one), the flags read in one host sync, or kept on the
    device while a graph is captured (`control.read`).
    `corr_kernel.window_variant(pre, tight, narrow)` names the window of
    read flags."""
    spose = coord_add(params.scanner_pose, states.poses)
    valid = scans.valid()
    pre = corr_kernel.corr_prepass(omap, spose, scans.ranges, scans.angles, valid)
    fits, tight, narrow = control.read(pre["fits"].all(), pre["tight"].all(),
                                       pre["narrow"].all())
    return pre, valid, fits, tight, narrow


def fleet_likelihood(omap, params, scans: FleetScan, states: MCLState,
                     model: str = "likelihood_field", backend: str = "corr"):
    """The fleet's measurement stage (fleet.py:109-221): (p (R, N), map
    factor (R, N)) for pf.filter.sensor_update. On "corr", inside the JAX
    gate, every robot's table comes from one `fleet_corr_table` launch in
    the smallest window all robots fit (tight 24 / narrow 32 / standard 64
    rows, a `corr_kernel.window_cond`); the factors are one batched read.
    Whether every robot fits is a `control.cond` ("fleet.fits"), whose
    false arm runs the robots one by one."""
    rmax = set(scans.range_max)
    if (backend != "corr" or model not in CORR_MODELS or omap.corr_psi_pad is None
            or len(rmax) != 1
            or omap.corr_psi_key != psi_fingerprint(model, params, rmax.pop())
            or not corr_kernel.map_fits(omap)):
        return _robot_by_robot(omap, params, scans, states, model, backend)
    r, n = states.poses.shape[:2]
    pre, valid, fits, tight, narrow = fleet_window(omap, params, scans, states)
    mf = map_factors(omap, params, states.poses.reshape(-1, 3)).reshape(r, n)
    n_beams = int(scans.ranges.shape[1])

    def table(rows, j0):
        tables = corr_kernel.fleet_corr_table(omap.corr_psi_pad, pre["off"], pre["nv"],
                                              pre["t_n"], corr_kernel.table_origin(pre, j0),
                                              n_beams, rows)
        s = torch.take_along_dim(tables.reshape(r, -1),
                                 corr_kernel.particle_flat(pre, rows, j0), dim=1)
        return corr_combine(model, params, s, valid.sum(1)[:, None])

    p = control.cond(
        fits, lambda: corr_kernel.window_cond(pre, tight, narrow, table, name="fleet.window"),
        lambda: _robot_by_robot(omap, params, scans, states, model, backend)[0],
        name="fleet.fits")
    return p, mf


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
    noise = _fleet_noise(noise, generator, states)
    states = odom_models.motion_update(states, odom_model, alphas, odom_poses, odom_deltas,
                                       noise.odom, absolute_motions)
    p, mf = fleet_likelihood(omap, scan_params, scans, states, laser_model, backend)
    states = pf_filter.sensor_update(states, p, mf)
    if resample_model == ResampleModel.SYSTEMATIC:
        return pf_filter.fleet_resample_systematic(states, params, pools, noise.start)
    return pf_filter.fleet_resample(states, params, pools, noise.inject, noise.pick)


def _fleet_noise(noise, generator, states) -> FleetNoise:
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("pass noise or a torch.Generator")
    r, m = states.weights.shape
    return FleetNoise.draw(generator, r, m, states.poses.device)


_fleet_step_graph = graph_jit(fleet_step, static_argnames=(
    "params", "odom_model", "laser_model", "resample_model", "backend"))


def make_fleet_step(params: PFParams, odom_model=odom_models.OdomModel.DIFF,
                    laser_model: str = "likelihood_field",
                    resample_model=ResampleModel.MULTINOMIAL, backend: str = "corr"):
    """`fleet_step` with its model choices bound and compiled
    (fleet.py:252-263, JAX's jit): step(states, omap, scan_params, scans,
    pools, odom_poses, odom_deltas, absolute_motions, alphas, noise=...,
    generator=...). On CUDA tensors each static key (the model choices,
    the alphas and each robot's range_max among them) is captured once
    into a CUDA graph (`utils.graph.graph_jit`, `step.graph`) and replayed
    with no host read; on CPU tensors the step runs eagerly. The variates
    are drawn before the replay, the odometry copied to the card if it is
    host data."""
    if backend not in FLEET_BACKENDS:
        raise ValueError(f"backend must be one of {FLEET_BACKENDS}, got {backend!r}")
    odom_model = odom_models.OdomModel(odom_model)
    resample_model = ResampleModel(resample_model)

    def step(states, omap, scan_params, scans, pools, odom_poses, odom_deltas,
             absolute_motions, alphas, noise: Optional[FleetNoise] = None,
             generator: Optional[torch.Generator] = None) -> MCLState:
        dev = states.poses.device
        return _fleet_step_graph(
            states, omap, scan_params, scans, pools, device_tensor(odom_poses, dev),
            device_tensor(odom_deltas, dev), device_tensor(absolute_motions, dev),
            tuple(float(a) for a in alphas), params, odom_model, laser_model, resample_model,
            backend, noise=_fleet_noise(noise, generator, states))

    step.graph = _fleet_step_graph
    return step


def init_fleet_group(init_method: str, world_size: int, rank: int, device="cuda",
                     backend: Optional[str] = None):
    """`torch.distributed.init_process_group` for a sharded fleet, with its
    address (`tcp://host:port` or `file://path`), world size and rank:
    NCCL for a CUDA fleet, gloo for a CPU one, unless the caller names the
    backend (gloo for ranks that share one card, which NCCL refuses).
    Returns the default group."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dist.group.WORLD


def rank_device(group=None) -> torch.device:
    """This rank's card: cuda:{LOCAL_RANK} where the launcher sets it
    (torchrun), else cuda:{rank % device_count}. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank: pass device='cpu' for a CPU fleet")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank(group) % torch.cuda.device_count()
    return torch.device("cuda", index)


def _comm_device(group, device) -> torch.device:
    """Where a collective's tensors live: the CPU for gloo, else `device`."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else torch.device(device)


def _robot_count(x) -> int:
    """Leading (robot) size of a tensor, or of a dataclass's first tensor."""
    if isinstance(x, torch.Tensor):
        return x.shape[0]
    return next(getattr(x, f.name).shape[0] for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor))


def _robot_rows(x, lo: int, hi: int):
    """Rows lo:hi along the robot axis of a tensor, a tuple (FleetScan's
    range_max) or a dataclass of them."""
    if isinstance(x, (torch.Tensor, tuple)):
        return x[lo:hi]
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _robot_rows(getattr(x, f.name), lo, hi)
                          for f in dataclasses.fields(x)})
    return x


def shard_robots(x, group=None):
    """This rank's contiguous block of R / world robots (in rank order, as
    `P("fleet")`) of a whole-fleet tensor, MCLState, FleetScan or
    FleetNoise; raises unless the world size divides R."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    r = _robot_count(x)
    if r % world:
        raise ValueError(f"{r} robots do not split over {world} ranks")
    return _robot_rows(x, rank * (r // world), (rank + 1) * (r // world))


def gather_robots(states: MCLState, group=None) -> MCLState:
    """The whole fleet's state on every rank, the ranks' blocks in rank
    order (`all_gather` of every tensor; through the CPU for gloo), on the
    states' device."""
    world = dist.get_world_size(group)
    dev = states.poses.device
    comm = _comm_device(group, dev)

    def gather(t):
        x = t.to(comm)
        x = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts).to(dtype=t.dtype, device=dev)

    return map_tensors(gather, states)


def make_sharded_fleet_step(group, params: PFParams, odom_model=odom_models.OdomModel.DIFF,
                            laser_model: str = "likelihood_field",
                            resample_model=ResampleModel.MULTINOMIAL, backend: str = "corr",
                            *, n_robots: int, device=None):
    """The multi-card fleet step (fleet.py:266-296): robots split over the
    process group's ranks (None: the default group) in contiguous blocks
    of R / world, map and parameters replicated. Returns step(states,
    omap, scan_params, scans, pools, odom_poses, odom_deltas,
    absolute_motions, alphas, noise=None, generator=None), which takes
    this rank's robots (`shard_robots`) and their `FleetNoise` or a
    per-rank torch.Generator, and runs `fleet_step` on them: no
    collective. The step is `make_fleet_step`'s compiled one (`step.graph`),
    one graph entry per rank's card. See the module docstring for the
    per-rank noise stream.

    n_robots: the whole fleet's robot count (JAX reads it from the global
    array), checked against each step's robots. device: this rank's
    device (default `rank_device`). Raises where JAX cannot run: a backend
    outside FLEET_BACKENDS, a robot count the world size does not divide,
    a rank's tensors off its device."""
    if backend not in FLEET_BACKENDS:
        raise ValueError(f"backend must be one of {FLEET_BACKENDS}, got {backend!r}")
    world = dist.get_world_size(group)
    if n_robots % world:
        raise ValueError(f"{n_robots} robots do not split over {world} ranks")
    dev = torch.device(device) if device is not None else rank_device(group)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    local = make_fleet_step(params, odom_model, laser_model, resample_model, backend)

    def step(states, omap, scan_params, scans, pools, odom_poses, odom_deltas,
             absolute_motions, alphas, noise: Optional[FleetNoise] = None,
             generator: Optional[torch.Generator] = None) -> MCLState:
        r = states.poses.shape[0]
        if r != n_robots // world:
            raise ValueError(f"rank {dist.get_rank(group)} holds {r} robots, not "
                             f"{n_robots} / {world}")
        given = [states.poses, scans.ranges, pools, odom_poses, odom_deltas, absolute_motions,
                 omap.distances]
        if noise is not None:
            given += [noise.odom, noise.inject, noise.pick]
        for t in given:
            if isinstance(t, torch.Tensor) and t.device != dev:
                raise ValueError(f"rank {dist.get_rank(group)}: a tensor on {t.device}, "
                                 f"not on the rank's device {dev}")
        return local(states, omap, scan_params, scans, pools, odom_poses, odom_deltas,
                     absolute_motions, alphas, noise=noise, generator=generator)

    step.graph = local.graph
    return step
